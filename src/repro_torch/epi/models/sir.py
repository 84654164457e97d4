"""Classic stochastic SIR model in PyTorch rows.

X = [S, I, R], theta = [beta, gamma, kappa] under U(0, [2, 1, 2]):

    S -> I   beta * S * I / P
    I -> R   gamma * I

Seeding: I0 = kappa * A0, R0 from the dataset, S = P - (I0 + R0). The
observed channels are (I, R). Every product is written in the order of
`repro.epi.models.sir`, and the CUDA kernel's struct (`kernels/csrc/sir.cuh`)
repeats it.
"""

from __future__ import annotations

import torch

from repro_torch.epi.models import register
from repro_torch.epi.spec import CompartmentalModel


def _hazard_rows(sc, pc, population):
    s, i, _r = sc
    beta, gamma, _kappa = pc
    return (
        beta * s * i / population,  # S -> I
        gamma * i,  # I -> R
    )


def _initial_rows(pc, population, a0, r0, _d0):
    kappa = pc[2]
    i0 = kappa * a0
    s0 = population - (i0 + r0)
    zeros = torch.zeros_like(kappa)
    return (s0, i0, zeros + r0)


MODEL = register(
    CompartmentalModel(
        name="sir",
        compartments=("S", "I", "R"),
        param_names=("beta", "gamma", "kappa"),
        prior_highs=(2.0, 1.0, 2.0),
        stoichiometry=(
            # S   I   R
            (-1, +1, 0),  # S -> I
            (0, -1, +1),  # I -> R
        ),
        observed=("I", "R"),
        hazard_rows=_hazard_rows,
        initial_rows=_initial_rows,
        # beta*S*I/P: 2 muls and a div; gamma*I
        hazard_ops=4,
        default_theta=(0.5, 0.2, 1.0),
        doc="Kermack-McKendrick stochastic SIR (tau-leaped).",
    )
)
