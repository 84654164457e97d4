"""Seeded stand-ins for the two inputs of Li et al. 2020's 375-city model
(Science 368:489, doi:10.1126/science.abb3221) that are not in the
repository: the daily traveller matrix (Tencent's location data in the
paper) and the city populations.

    python3 experiments/li2020_inputs.py [--out perfbench/configs]

writes `li2020_travellers.npy` (375 x 375 float32, zero diagonal, entry
[r][q] the travellers from city q to city r a day) and
`li2020_populations.npy` (375 float32), byte for byte the same on every run.

Cities lie at seeded points of a 4,000 x 3,000 km box, with log-normal
populations (median 2.5 million, sigma 0.8) scaled so that the 375 hold
1.30 billion, Wuhan (city `WUHAN`, at the box's centre) 11.08 million. The
travellers follow a gravity model, P_r * P_q / d^2 over distances floored
at 50 km, scaled so that 2% of all people travel between cities each day:
the Spring Festival's ~3 billion trips in 40 days (~75 million a day, ~5%
of the people) counted every journey, and a part of them stayed inside a
city's prefecture, which the paper's matrix does not count.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SEED = 20200110
N_CITIES = 375
#: Wuhan's row and column
WUHAN = 169
WUHAN_POPULATION = 11.08e6
TOTAL_POPULATION = 1.30e9
#: travellers between cities a day, as a share of all the cities' people
TRAVEL_SHARE = 0.02
BOX_KM = (4000.0, 3000.0)
FLOOR_KM = 50.0


def inputs():
    """(travellers [375, 375], populations [375]) as float32 arrays."""
    rng = np.random.default_rng(SEED)
    xy = rng.uniform((0.0, 0.0), BOX_KM, size=(N_CITIES, 2))
    xy[WUHAN] = (BOX_KM[0] / 2, BOX_KM[1] / 2)
    pops = rng.lognormal(np.log(2.5e6), 0.8, size=N_CITIES)
    pops[WUHAN] = 0.0
    pops *= (TOTAL_POPULATION - WUHAN_POPULATION) / pops.sum()
    pops[WUHAN] = WUHAN_POPULATION
    d = np.sqrt(((xy[:, None, :] - xy[None, :, :]) ** 2).sum(axis=-1))
    gravity = np.outer(pops, pops) / np.maximum(d, FLOOR_KM) ** 2
    np.fill_diagonal(gravity, 0.0)
    travellers = gravity * (TRAVEL_SHARE * TOTAL_POPULATION / gravity.sum())
    return travellers.astype(np.float32), pops.astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(Path(__file__).resolve().parents[1] / "perfbench"
                                        / "configs"))
    args = p.parse_args(argv)
    travellers, pops = inputs()
    out = Path(args.out)
    np.save(out / "li2020_travellers.npy", travellers)
    np.save(out / "li2020_populations.npy", pops)
    leave = travellers.sum(axis=0) / pops
    print(f"populations {pops.sum():.6g} (Wuhan {pops[WUHAN]:.6g}, least {pops.min():.6g}, "
          f"most {pops.max():.6g}); travellers a day {travellers.sum(dtype=np.float64):.6g}; "
          f"share leaving a city a day: median {np.median(leave):.4f}, most {leave.max():.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
