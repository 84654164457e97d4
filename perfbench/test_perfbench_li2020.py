"""Li et al. 2020's configuration (`configs/li2020_china.json`, model file
`models/li2020.py`): its inputs reproduced from their seed, its frozen
operation counts, and the program's plain path held to the reference bit
for bit at 12 cities (a seeded traveller matrix and populations, the seed
city not row 0): the series, one wave, the pilot's tolerance and a
posterior."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import counting
from perfbench import harness
from perfbench import reference as ref

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "configs" / "li2020_china.json").read_text())
#: the cities of the tiny case
CITIES = 12


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The configuration at 12 cities and 10 days: seeded traveller counts
    (zero diagonal, up to 3,000 a day) and populations among the
    configurations' files, city 5 seeded."""
    rng = np.random.default_rng(2020)
    mob = (rng.random((CITIES, CITIES)) * 3e3 * (1 - np.eye(CITIES))).astype(np.float32)
    pops = rng.uniform(2e5, 2e6, CITIES).astype(np.float32)
    np.save(tmp_path / "travellers_12.npy", mob)
    np.save(tmp_path / "populations_12.npy", pops)
    monkeypatch.setattr(ref, "CONFIGS", tmp_path)
    return dict(CONFIG, regions=CITIES, days=10, seed_region=5,
                mobility={"file": "travellers_12.npy"},
                populations={"file": "populations_12.npy"})


def program(cfg: dict, observed: np.ndarray, batch: int):
    from repro_torch.core import abc
    from repro_torch.epi.data import CountryData

    spec = harness.program_spec(cfg)
    ds = CountryData(name=cfg["name"], population=cfg["population"], a0=cfg["a0"],
                     r0=cfg["r0"], d0=cfg["d0"], observed=observed, model=spec.name,
                     observed_channels=spec.observed_labels)
    acfg = abc.ABCConfig(batch_size=batch, chunk_size=batch, target_accepted=20,
                         max_runs=40, model=spec, num_days=cfg["days"], wave_loop="device")
    return ds, acfg, abc.make_simulator(ds, acfg, "cpu"), spec


def test_inputs_script_reproduces_the_files(tmp_path):
    sys.path.insert(0, str(HERE.parent / "experiments"))
    try:
        import li2020_inputs
    finally:
        sys.path.pop(0)
    assert li2020_inputs.main(["--out", str(tmp_path)]) == 0
    for name in ("li2020_travellers.npy", "li2020_populations.npy"):
        assert (tmp_path / name).read_bytes() == (HERE / "configs" / name).read_bytes(), name
    mob = np.load(tmp_path / "li2020_travellers.npy")
    pops = np.load(tmp_path / "li2020_populations.npy")
    assert (np.diag(mob) == 0).all() and (mob >= 0).all() and np.isfinite(mob).all()
    assert pops[CONFIG["seed_region"]] == np.float32(11.08e6)
    assert 0.005 <= mob.sum(dtype=np.float64) / pops.sum(dtype=np.float64) <= 0.05


def test_frozen_counts_are_the_file_and_near_the_hand_count():
    """`counting.py`'s counts are the file's; a sample-day is within 2% of
    the hand count: the three coupled rows, 3 R (2R - 1), and a city's 658
    operations: 11 transitions of two uniforms (a hash of 18 and 3 more
    each), Box-Muller's 6 and the tau-leap's 4; the hazards' clamp (11),
    the sourced clamps and the budget's subtractions (8 x 2) and the
    inflows' clamps (3), the stoichiometry (5 moves x 2 and 6 ends x 1),
    the hazards and coupled inputs (26, the parameter products counted a
    sample), and the two channels' running distance (7 each)."""
    got = counting.counts(CONFIG)
    assert got["ops_per_sample_day"] == CONFIG["ops_per_sample_day"]
    assert got["ops_per_sample"] == CONFIG["ops_per_sample"]
    R = CONFIG["regions"]
    city = 11 * (2 * (18 + 3) + 6 + 4) + 11 + 8 * 2 + 3 + (5 * 2 + 6) + 26 + 2 * 7
    hand = 3 * R * (2 * R - 1) + R * city
    assert city == 658
    assert abs(got["ops_per_sample_day"] / hand - 1.0) < 0.02


def test_series_and_wave_bitwise(tiny):
    from repro_torch.core.priors import schedule_prior
    from repro_torch.epi.data import synthetic_dataset

    model = ref.Model(tiny)
    obs = ref.observed_series(model, tiny["theta"], tiny["data_seed"])
    assert (obs[2 * 5] > 0).any(), "the seeded city documents no case"
    ds, acfg, sim, spec = program(tiny, obs, 256)
    assert spec.populations == tuple(float(x) for x in model.populations)
    assert spec.seed_region == 5 and spec.mobility_counts
    theirs = synthetic_dataset(tuple(tiny["theta"]), tiny["population"], tiny["days"],
                               tiny["a0"], tiny["r0"], tiny["d0"], seed=tiny["data_seed"],
                               model=spec)
    assert np.array_equal(theirs.observed.view(np.int32), obs.view(np.int32))
    theta, dist = sim.wave(schedule_prior(spec), 1234, 5678, 256, offset=300)
    c = model.on("cpu").with_observed(obs)
    idx = torch.arange(300, 556)
    mine = ref.prior_draw(c, 1234, idx)
    assert torch.equal(mine.view(torch.int32), theta.view(torch.int32))
    assert torch.equal(ref.distances(c, mine, 5678, idx).view(torch.int32),
                       dist.view(torch.int32))


def test_pilot_and_posterior_bitwise(tiny):
    from repro_torch.core import abc
    from repro_torch.core.priors import schedule_prior

    model = ref.Model(tiny)
    obs = ref.observed_series(model, tiny["theta"], tiny["data_seed"])
    ds, acfg, sim, spec = program(tiny, obs, 500)
    tol = abc.calibrate_tolerance(ds, acfg, seed=9, quantile=0.01, n_pilot=1500, simulator=sim)
    c = model.on("cpu").with_observed(obs)
    assert ref.pilot_tolerance(c, 9, 0.01, 1500, 500) == tol
    acfg = dataclasses.replace(acfg, tolerance=tol, target_accepted=10)
    runner = abc.make_wave_runner(schedule_prior(spec), sim, acfg)
    post = abc.run_abc(ds, acfg, seed=2**32 - 5, wave_runner=runner)
    theta, dist, waves = ref.posterior(c, 2**32 - 5, tol, 500, 10, 40)
    assert waves == post.runs
    assert ref.mismatched_rows(post.theta, post.distances, theta, dist) == 0
    assert len(dist) >= 10
