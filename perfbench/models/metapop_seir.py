"""Metapopulation SEIR (Keeling and Rohani 2008, ch. 7) as plain rows for
the benchmark's reference: SEIR patches coupled by mobility.

State [S, E, I, R] a region, theta = [beta, sigma, gamma, kappa] shared by
the regions. Region r's exposure uses the mobility-weighted infectious mass
i_eff_r = sum_q M[r, q] * I_q (the coupled row the engine appends):

    S_r -> E_r   beta * S_r * i_eff_r / P_r
    E_r -> I_r   sigma * E_r
    I_r -> R_r   gamma * I_r
"""

import torch

COMPARTMENTS = ("S", "E", "I", "R")
OBSERVED = ("I", "R")
COUPLED = ("I",)
STOICHIOMETRY = (
    # S   E   I   R
    (-1, +1, 0, 0),  # S -> E
    (0, -1, +1, 0),  # E -> I
    (0, 0, -1, +1),  # I -> R
)


def hazard_rows(sc, pc, population):
    s, e, i, _r, i_eff = sc
    beta, sigma, gamma, _kappa = pc
    return (beta * s * i_eff / population, sigma * e, gamma * i)


def initial_rows(pc, population, a0, r0, _d0):
    """E0 = kappa * A0, I0 = A0, S = P_r - (E0 + A0 + R0) in the seeded
    region; every other region holds P_r susceptibles."""
    kappa = pc[3]
    e0 = kappa * a0
    zeros = torch.zeros_like(a0) * kappa
    i0 = zeros + a0
    s0 = population - (e0 + a0 + r0)
    return (s0, e0, i0, zeros + r0)
