"""Li et al. 2020's model of documented and undocumented COVID-19 spread
between cities, in PyTorch rows.

Li, Pei, Chen, Song, Zhang, Yang and Shaman, "Substantial undocumented
infection facilitates the rapid dissemination of novel coronavirus
(SARS-CoV-2)", Science 368:489-493 (2020), doi:10.1126/science.abb3221,
Methods: 375 Chinese cities coupled each day by a traveller matrix.

Six compartments a city, [S, E, Ir, Iu, Rr, Ru]: documented (Ir) and
undocumented (Iu) infections, each removed to its own R, so that the
cumulative documented cases Ir + Rr can be observed (the paper has one R;
the split changes no dynamics). theta = [beta, mu, theta, Z, D, alpha, E0,
Iu0] under the paper's box. M[r][q] is the daily travellers from city q to
city r (`mobility_counts`), out_q = sum_r M[r][q] those leaving q, N_r city
r's population. Eleven transitions a city, in clamp order:

    S  -> E    beta * S * Ir / N + mu * beta * S * Iu / N
    E  -> Ir   alpha * E / Z
    E  -> Iu   (1 - alpha) * E / Z
    Ir -> Rr   Ir / D
    Iu -> Ru   Iu / D
    -> S, S ->   theta * sum_q M[r][q] * S_q / (N_q - Ir_q),  theta * out_r / (N_r - Ir_r) * S_r
    -> E, E ->   the same for E
    -> Iu, Iu -> the same for Iu

Documented cases do not travel. The coupled compartments are S, E and Iu;
`coupled_inputs` hands the matrix X_q / (N_q - Ir_q), and
`region_constants` gives out_q, summed over r = 0 upward. E0 and Iu0 seed
`seed_region` (Wuhan) alone: E(0) = E0 * a0 and Iu(0) = Iu0 * a0 there, a0
being the dataset's seed scale (1 for the paper's setting), Ir(0) = r0,
Rr(0) = d0. Departures from the paper: Gaussian tau-leap counts for its
Poisson draws (as every model of the repository), N held fixed (the paper
moves it by the day's net travel), no reporting delay, and ABC rejection
for its ensemble adjustment Kalman filter.

The registered spec has 4 cities exchanging 2,000 travellers a day each
way; `epi.spec.regionalize` takes it to the 375 cities and a traveller
matrix, and `dataclasses.replace(spec, populations=...)` gives each city
its population. Its CUDA struct is `kernels/csrc/li2020.cuh`, which only
the tile route of the region axis runs (inflow and outflow rows, a
population a city, region constants).
"""

from __future__ import annotations

import torch

from repro_torch.epi.models import register
from repro_torch.epi.spec import CompartmentalModel


def _coupled_inputs(sc, population):
    """S, E and Iu over N - Ir: the rows the traveller matrix multiplies."""
    s, e, ir, iu = sc[0], sc[1], sc[2], sc[3]
    present = population - ir
    return (s / present, e / present, iu / present)


def _region_constants(mobility, _population):
    """out_q = sum_r M[r][q], the travellers leaving each city, r = 0 upward."""
    out = mobility[0]
    for r in range(1, mobility.shape[0]):
        out = out + mobility[r]
    return (out,)


def _hazard_rows(sc, pc, population):
    s, e, ir, iu, _rr, _ru, s_in, e_in, iu_in, out = sc
    beta, mu, theta, z, d, alpha, _e0, _iu0 = pc
    leave = theta * out / (population - ir)
    return (
        beta * s * ir / population + mu * beta * s * iu / population,  # S -> E
        alpha * e / z,  # E -> Ir
        (1.0 - alpha) * e / z,  # E -> Iu
        ir / d,  # Ir -> Rr
        iu / d,  # Iu -> Ru
        theta * s_in,  # -> S
        leave * s,  # S ->
        theta * e_in,  # -> E
        leave * e,  # E ->
        theta * iu_in,  # -> Iu
        leave * iu,  # Iu ->
    )


def _initial_rows(pc, population, a0, r0, d0):
    e0 = pc[6] * a0
    iu0 = pc[7] * a0
    zeros = torch.zeros_like(e0)
    return (population - (e0 + iu0 + r0 + d0), e0, zeros + r0, iu0, zeros + d0, zeros)


N_REGIONS = 4
#: travellers a day between each pair of the registered spec's cities
TRAVELLERS = 2000.0

MODEL = register(
    CompartmentalModel(
        name="li2020",
        compartments=("S", "E", "Ir", "Iu", "Rr", "Ru"),
        param_names=("beta", "mu", "theta", "Z", "D", "alpha", "E0", "Iu0"),
        prior_lows=(0.8, 0.2, 1.0, 2.0, 2.0, 0.02, 0.0, 0.0),
        prior_highs=(1.5, 1.0, 1.75, 5.0, 5.0, 1.0, 2000.0, 2000.0),
        stoichiometry=(
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
        ),
        observed=("Ir", "Rr"),
        hazard_rows=_hazard_rows,
        initial_rows=_initial_rows,
        # the hazards' 24 operations less the parameter products mu * beta
        # and 1 - alpha, and the coupled inputs' subtraction and 3
        # divisions (the coupled rows are counted apart,
        # `kernels.abc_sim.ops_per_sample_day`)
        hazard_ops=26,
        # the paper's Table 1 before the travel restrictions; E0 = Iu0 = 1,000
        default_theta=(1.12, 0.55, 1.36, 3.69, 3.47, 0.14, 1000.0, 1000.0),
        n_regions=N_REGIONS,
        mobility=tuple(tuple(0.0 if q == r else TRAVELLERS for q in range(N_REGIONS))
                       for r in range(N_REGIONS)),
        coupled=("S", "E", "Iu"),
        mobility_counts=True,
        coupled_inputs=_coupled_inputs,
        region_constants=_region_constants,
        doc="Li et al. 2020: documented and undocumented infection in cities "
            "coupled by travellers.",
    )
)
