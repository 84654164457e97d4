"""SEIARD: the paper's SIARD model with an exposed stage, in PyTorch rows.

X = [S, E, I, A, R, D, Ru], theta = [alpha0, alpha, n, beta, gamma, delta,
eta, kappa, epsilon] under U(0, [1, 100, 2, 1, 1, 1, 1, 2, 1]):

    S -> E   g(A, R, D) * S * I / P     (eq. 4)
    E -> I   epsilon * E
    I -> A   gamma * I
    A -> R   beta * A
    A -> D   delta * A
    I -> Ru  beta * eta * I

Seeding: I0 = E0 = kappa * A0, S = P - (A0 + R0 + D0 + I0 + E0). The
observed channels are SIARD's (A, R, D), so it fits the country series.
Every product is written in the order of `repro.epi.models.seiard`, and the
CUDA kernel's struct (`kernels/csrc/seiard.cuh`) repeats it.
"""

from __future__ import annotations

import torch

from repro_torch.epi.models import register
from repro_torch.epi.models.siard import behavioural_infection_rate
from repro_torch.epi.spec import CompartmentalModel


def _hazard_rows(sc, pc, population):
    s, e, i, a, r, d, _ru = sc
    alpha0, alpha, n, beta, gamma, delta, eta, _kappa, epsilon = pc
    g = behavioural_infection_rate(alpha0, alpha, n, a + r + d)
    return (
        g * s * i / population,  # S -> E
        epsilon * e,  # E -> I
        gamma * i,  # I -> A
        beta * a,  # A -> R
        delta * a,  # A -> D
        beta * eta * i,  # I -> Ru
    )


def _initial_rows(pc, population, a0, r0, d0):
    kappa = pc[7]
    i0 = kappa * a0
    e0 = kappa * a0
    s0 = population - (a0 + r0 + d0 + i0 + e0)
    zeros = torch.zeros_like(kappa)
    return (s0, e0, i0, zeros + a0, zeros + r0, zeros + d0, zeros)


MODEL = register(
    CompartmentalModel(
        name="seiard",
        compartments=("S", "E", "I", "A", "R", "D", "Ru"),
        param_names=(
            "alpha0", "alpha", "n", "beta", "gamma", "delta", "eta", "kappa",
            "epsilon",
        ),
        prior_highs=(1.0, 100.0, 2.0, 1.0, 1.0, 1.0, 1.0, 2.0, 1.0),
        stoichiometry=(
            # S   E   I   A   R   D  Ru
            (-1, +1, 0, 0, 0, 0, 0),  # S -> E
            (0, -1, +1, 0, 0, 0, 0),  # E -> I
            (0, 0, -1, +1, 0, 0, 0),  # I -> A
            (0, 0, 0, -1, +1, 0, 0),  # A -> R
            (0, 0, 0, -1, 0, +1, 0),  # A -> D
            (0, 0, -1, 0, 0, 0, +1),  # I -> Ru
        ),
        observed=("A", "R", "D"),
        hazard_rows=_hazard_rows,
        initial_rows=_initial_rows,
        # SIARD's 14 and epsilon * E
        hazard_ops=15,
        default_theta=(0.384, 36.054, 0.595, 0.013, 0.385, 0.009, 0.477, 0.830, 0.4),
        doc="Paper SIARD extended with an exposed/latent compartment.",
    )
)
