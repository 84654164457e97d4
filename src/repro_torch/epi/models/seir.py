"""Stochastic SEIR model in PyTorch rows.

X = [S, E, I, R], theta = [beta, sigma, gamma, kappa] under
U(0, [2, 1, 1, 2]):

    S -> E   beta * S * I / P
    E -> I   sigma * E
    I -> R   gamma * I

Seeding: I0 = A0, E0 = kappa * A0, R0 from the dataset,
S = P - (E0 + A0 + R0). The observed channels are (I, R). Every product is
written in the order of `repro.epi.models.seir`, and the CUDA kernel's
struct (`kernels/csrc/seir.cuh`) repeats it.
"""

from __future__ import annotations

import torch

from repro_torch.epi.models import register
from repro_torch.epi.spec import CompartmentalModel


def _hazard_rows(sc, pc, population):
    s, e, i, _r = sc
    beta, sigma, gamma, _kappa = pc
    return (
        beta * s * i / population,  # S -> E
        sigma * e,  # E -> I
        gamma * i,  # I -> R
    )


def _initial_rows(pc, population, a0, r0, _d0):
    kappa = pc[3]
    e0 = kappa * a0
    zeros = torch.zeros_like(kappa)
    i0 = zeros + a0
    s0 = population - (e0 + a0 + r0)
    return (s0, e0, i0, zeros + r0)


MODEL = register(
    CompartmentalModel(
        name="seir",
        compartments=("S", "E", "I", "R"),
        param_names=("beta", "sigma", "gamma", "kappa"),
        prior_highs=(2.0, 1.0, 1.0, 2.0),
        stoichiometry=(
            # S   E   I   R
            (-1, +1, 0, 0),  # S -> E
            (0, -1, +1, 0),  # E -> I
            (0, 0, -1, +1),  # I -> R
        ),
        observed=("I", "R"),
        hazard_rows=_hazard_rows,
        initial_rows=_initial_rows,
        # beta*S*I/P: 2 muls and a div; sigma*E; gamma*I
        hazard_ops=5,
        default_theta=(0.6, 0.3, 0.2, 1.0),
        doc="SEIR with exposed/latent compartment (tau-leaped).",
    )
)
