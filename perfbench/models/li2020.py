"""Li, Pei, Chen, Song, Zhang, Yang and Shaman, Science 368:489-493 (2020),
doi:10.1126/science.abb3221, as plain rows for the benchmark's reference:
375 cities, documented (Ir) and undocumented (Iu) infection, coupled each
day by a traveller matrix.

State [S, E, Ir, Iu, Rr, Ru] a city (Rr and Ru split the paper's R so that
the cumulative documented cases Ir + Rr can be observed), theta = [beta,
mu, theta, Z, D, alpha, E0, Iu0]. M[r, q] is the daily travellers from
city q to city r, out_q = sum_r M[r, q], N_r the city's population:

    S  -> E    beta * S * Ir / N + mu * beta * S * Iu / N
    E  -> Ir   alpha * E / Z
    E  -> Iu   (1 - alpha) * E / Z
    Ir -> Rr   Ir / D
    Iu -> Ru   Iu / D
    -> X       theta * sum_q M[r, q] * X_q / (N_q - Ir_q)     X in S, E, Iu
    X ->       theta * out_r / (N_r - Ir_r) * X_r

Documented cases do not travel. E0 and Iu0 seed the configuration's
`seed_region` (Wuhan) alone, scaled by a0. Each product is written in the
order of the measured program, so that float32 rounds alike.
"""

import dataclasses

import torch

COMPARTMENTS = ("S", "E", "Ir", "Iu", "Rr", "Ru")
OBSERVED = ("Ir", "Rr")
COUPLED = ("S", "E", "Iu")
STOICHIOMETRY = (
    # S   E  Ir  Iu  Rr  Ru
    (-1, +1, 0, 0, 0, 0),  # S -> E
    (0, -1, +1, 0, 0, 0),  # E -> Ir
    (0, -1, 0, +1, 0, 0),  # E -> Iu
    (0, 0, -1, 0, +1, 0),  # Ir -> Rr
    (0, 0, 0, -1, 0, +1),  # Iu -> Ru
    (+1, 0, 0, 0, 0, 0),  # -> S
    (-1, 0, 0, 0, 0, 0),  # S ->
    (0, +1, 0, 0, 0, 0),  # -> E
    (0, -1, 0, 0, 0, 0),  # E ->
    (0, 0, 0, +1, 0, 0),  # -> Iu
    (0, 0, 0, -1, 0, 0),  # Iu ->
)


def coupled_inputs(sc, population):
    """S, E and Iu over N - Ir."""
    s, e, ir, iu = sc[0], sc[1], sc[2], sc[3]
    present = population - ir
    return (s / present, e / present, iu / present)


def region_constants(mobility, _population):
    """out_q = sum_r M[r, q], rows r = 0 upward."""
    out = mobility[0]
    for r in range(1, mobility.shape[0]):
        out = out + mobility[r]
    return (out,)


def hazard_rows(sc, pc, population):
    s, e, ir, iu, _rr, _ru, s_in, e_in, iu_in, out = sc
    beta, mu, theta, z, d, alpha, _e0, _iu0 = pc
    leave = theta * out / (population - ir)
    return (beta * s * ir / population + mu * beta * s * iu / population,
            alpha * e / z, (1.0 - alpha) * e / z, ir / d, iu / d,
            theta * s_in, leave * s, theta * e_in, leave * e, theta * iu_in, leave * iu)


def initial_rows(pc, population, a0, r0, d0):
    """E = E0 * a0 and Iu = Iu0 * a0 in the seeded city, Ir = r0, Rr = d0,
    S = N - (E + Iu + r0 + d0)."""
    e0 = pc[6] * a0
    iu0 = pc[7] * a0
    zeros = torch.zeros_like(e0)
    return (population - (e0 + iu0 + r0 + d0), e0, zeros + r0, iu0, zeros + d0, zeros)


def program_spec(config, spec):
    """The program's spec with the configuration's city populations."""
    from perfbench.reference import config_array

    pops = config_array(config["populations"], (int(config["regions"]),))
    return dataclasses.replace(spec, populations=tuple(float(x) for x in pops))
