"""The paper's six-compartment COVID-19 model (§2.1) in PyTorch rows.

X = [S, I, A, R, D, Ru], theta = [alpha0, alpha, n, beta, gamma, delta, eta,
kappa] under the prior U(0, [1, 100, 2, 1, 1, 1, 1, 2]) (eq. 2).

    g = alpha0 + alpha / (1 + (A + R + D)^n)                        eq. (4)
    h = (g*S*I/P, gamma*I, beta*A, delta*A, beta*eta*I)             eq. (5)

Transitions apply in the order S->I, I->A, A->R, A->D, I->Ru, which is also
the clamp order: A->R drains A before A->D, and I->A drains I before I->Ru.
Every product is written in the same order as `repro.epi.models.siard` so
that the float32 roundings agree; the CUDA kernel's struct
(`kernels/csrc/siard.cuh`) repeats it once more.
"""

from __future__ import annotations

import torch

from repro_torch.epi.models import register
from repro_torch.epi.spec import CompartmentalModel


def behavioural_infection_rate(alpha0, alpha, n, ard_sum):
    """g = alpha0 + alpha / (1 + max(A+R+D, 0)^n), eq. (4), on rows."""
    return alpha0 + alpha / (1.0 + torch.pow(torch.clamp_min(ard_sum, 0.0), n))


def _hazard_rows(sc, pc, population):
    """Eq. (5) as rows; `population` is a float32 tensor on the rows' device."""
    s, i, a, r, d, _ru = sc
    alpha0, alpha, n, beta, gamma, delta, eta, _kappa = pc
    g = behavioural_infection_rate(alpha0, alpha, n, a + r + d)
    return (
        g * s * i / population,  # S -> I
        gamma * i,  # I -> A
        beta * a,  # A -> R
        delta * a,  # A -> D
        beta * eta * i,  # I -> Ru
    )


def _initial_rows(pc, population, a0, r0, d0):
    """Paper step 1: Ru = 0, I0 = kappa * A0, S = P - (A0 + R0 + D0 + I0)."""
    kappa = pc[7]
    i0 = kappa * a0
    s0 = population - (a0 + r0 + d0 + i0)
    zeros = torch.zeros_like(kappa)
    return (s0, i0, zeros + a0, zeros + r0, zeros + d0, zeros)


MODEL = register(
    CompartmentalModel(
        name="siard",
        compartments=("S", "I", "A", "R", "D", "Ru"),
        param_names=("alpha0", "alpha", "n", "beta", "gamma", "delta", "eta", "kappa"),
        prior_highs=(1.0, 100.0, 2.0, 1.0, 1.0, 1.0, 1.0, 2.0),
        stoichiometry=(
            # S   I   A   R   D  Ru
            (-1, +1, 0, 0, 0, 0),  # S -> I   g*S*I/P
            (0, -1, +1, 0, 0, 0),  # I -> A   gamma*I
            (0, 0, -1, +1, 0, 0),  # A -> R   beta*A
            (0, 0, -1, 0, +1, 0),  # A -> D   delta*A
            (0, -1, 0, 0, 0, +1),  # I -> Ru  beta*eta*I
        ),
        observed=("A", "R", "D"),
        hazard_rows=_hazard_rows,
        initial_rows=_initial_rows,
        # g: 2 adds, clamp, pow, add, div, add; h: 3 + 1 + 1 + 1 + 1, with
        # beta * eta once per sample
        hazard_ops=14,
        # paper Table 8 Italy posterior means
        default_theta=(0.384, 36.054, 0.595, 0.013, 0.385, 0.009, 0.477, 0.830),
        doc="Paper §2.1 six-compartment COVID-19 model (the reproduction default).",
    )
)
