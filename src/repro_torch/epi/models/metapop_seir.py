"""Spatial metapopulation SEIR in PyTorch rows: coupled SEIR patches.

Four compartments [S, E, I, R] a region and four shared parameters [beta,
sigma, gamma, kappa] under U(0, [2, 1, 1, 2]). The exposure of region r
uses the mobility-weighted infectious mass i_eff = sum_q M[r, q] * I_q, the
coupled row that the engine (or the kernel) appends after the local rows
(`coupled=("I",)`):

    S_r -> E_r   beta * S_r * i_eff_r / P_r
    E_r -> I_r   sigma * E_r
    I_r -> R_r   gamma * I_r

P_r is population / R. The registered spec has R=4 regions on a ring
(each keeps 90% of its contacts, 5% go to each neighbour);
`epi.spec.regionalize` takes it to any R. Region `seed_region` (0) gets the
dataset's day-0 counts as seir does; every other region starts fully
susceptible. Every product is written in the order of
`repro.epi.models.metapop_seir`, and the CUDA kernel's struct
(`kernels/csrc/metapop_seir.cuh`) repeats it.
"""

from __future__ import annotations

import torch

from repro_torch.epi.models import register
from repro_torch.epi.spec import CompartmentalModel, make_mobility


def _hazard_rows(sc, pc, population):
    s, e, i, _r, i_eff = sc  # i_eff: the mobility-weighted I (coupled row)
    beta, sigma, gamma, _kappa = pc
    return (
        beta * s * i_eff / population,  # S -> E (coupled exposure)
        sigma * e,  # E -> I
        gamma * i,  # I -> R
    )


def _initial_rows(pc, population, a0, r0, _d0):
    kappa = pc[3]
    e0 = kappa * a0
    zeros = torch.zeros_like(a0) * kappa
    i0 = zeros + a0
    s0 = population - (e0 + a0 + r0)
    return (s0, e0, i0, zeros + r0)


N_REGIONS = 4

MODEL = register(
    CompartmentalModel(
        name="metapop_seir",
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
        # beta*S*i_eff/P: 2 muls and a div; sigma*E; gamma*I (the coupled
        # row is counted apart, `kernels.abc_sim.ops_per_sample_day`)
        hazard_ops=5,
        default_theta=(0.6, 0.3, 0.2, 1.0),
        n_regions=N_REGIONS,
        mobility=make_mobility("ring:0.1", N_REGIONS),
        coupled=("I",),
        doc="4-region metapopulation SEIR on a ring (10% mobility leakage).",
    )
)
