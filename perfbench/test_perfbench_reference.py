"""The reference against the port's CPU path (its plain version), bit for
bit, on tiny waves, and the frozen operation counts against the
configuration files."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import counting
from perfbench import harness
from perfbench import reference as ref

HERE = Path(__file__).resolve().parent
#: the region axis: metapop_seir on a ring, a test case of the reference
#: (no cell runs it yet)
METAPOP_RING = {
    "name": "metapop_ring", "model": "metapop_seir", "regions": 100, "mobility": {"ring": 0.1},
    "seed_region": 0, "summary": "identity", "distance": "euclidean",
    "theta": [0.6, 0.3, 0.2, 1.0], "prior_highs": [2.0, 1.0, 1.0, 2.0],
    "population": 1e6, "a0": 100.0, "r0": 0.0, "d0": 0.0, "days": 49, "data_seed": 7,
}
#: a prior box that is not the registered SIARD's, around siard_italy's theta
SIARD_BOX = {"prior_lows": [0.1, 10.0, 0.2, 0.001, 0.1, 0.001, 0.1, 0.5],
             "prior_highs": [0.8, 60.0, 1.5, 0.05, 0.7, 0.05, 0.9, 1.5]}
#: a configuration's mobility file: `mobility_file` writes it
MATRIX = "mobility_12.npy"
#: test cases beside the files: (the configuration they change, the keys changed)
VARIANTS = {
    "metapop_seed3": ("metapop_ring", {"seed_region": 3}),
    "metapop_matrix": ("metapop_ring", {"mobility": {"file": MATRIX}}),
    "siard_box": ("siard_italy", SIARD_BOX),
}
#: (configuration, regions and days of the tiny case)
CASES = [("siard_italy", 1, 49), ("metapop_ring", 12, 10), ("metapop_seed3", 12, 10),
         ("metapop_matrix", 12, 10), ("siard_box", 1, 49)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    small tensors on many threads each wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def mobility_file(tmp_path, monkeypatch):
    """`MATRIX` among the configurations' files: a seeded row-stochastic
    12 x 12 matrix, dense and not symmetric, so no ring."""
    rng = np.random.default_rng(20200316)
    m = rng.random((12, 12)) + 3.0 * np.eye(12)
    np.save(tmp_path / MATRIX, (m / m.sum(axis=1, keepdims=True)).astype(np.float32))
    monkeypatch.setattr(ref, "CONFIGS", tmp_path)


def load(config: str) -> dict:
    if config == METAPOP_RING["name"]:
        return METAPOP_RING
    if config in VARIANTS:
        base, keys = VARIANTS[config]
        return dict(load(base), name=config, **keys)
    return json.loads((HERE / "configs" / f"{config}.json").read_text())


def tiny(config: str, regions: int, days: int) -> dict:
    return dict(load(config), regions=regions, days=days)


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


@pytest.mark.parametrize("config,regions,days", CASES)
def test_series_and_wave_bitwise(config, regions, days, mobility_file):
    from repro_torch.core.priors import schedule_prior
    from repro_torch.epi.data import synthetic_dataset

    cfg = tiny(config, regions, days)
    model = ref.Model(cfg)
    obs = ref.observed_series(model, cfg["theta"], cfg["data_seed"])
    ds, acfg, sim, spec = program(cfg, obs, 512)
    theirs = synthetic_dataset(tuple(cfg["theta"]), cfg["population"], days, cfg["a0"],
                               cfg["r0"], cfg["d0"], seed=cfg["data_seed"], model=spec)
    assert np.array_equal(theirs.observed.view(np.int32), obs.view(np.int32))
    theta, dist = sim.wave(schedule_prior(spec), 1234, 5678, 512, offset=300)
    c = model.on("cpu").with_observed(obs)
    idx = torch.arange(300, 812)
    mine = ref.prior_draw(c, 1234, idx)
    assert torch.equal(mine.view(torch.int32), theta.view(torch.int32))
    assert torch.equal(ref.distances(c, mine, 5678, idx).view(torch.int32),
                       dist.view(torch.int32))


@pytest.mark.parametrize("config,regions,days", CASES)
def test_pilot_and_posterior_bitwise(config, regions, days, mobility_file):
    from repro_torch.core import abc
    from repro_torch.core.priors import schedule_prior

    cfg = tiny(config, regions, days)
    model = ref.Model(cfg)
    obs = ref.observed_series(model, cfg["theta"], cfg["data_seed"])
    ds, acfg, sim, spec = program(cfg, obs, 1000)
    tol = abc.calibrate_tolerance(ds, acfg, seed=9, quantile=0.01, n_pilot=3000,
                                  simulator=sim)
    c = model.on("cpu").with_observed(obs)
    assert ref.pilot_tolerance(c, 9, 0.01, 3000, 1000) == tol
    acfg = dataclasses.replace(acfg, tolerance=tol)
    runner = abc.make_wave_runner(schedule_prior(spec), sim, acfg)
    for seed in (5, 2**32 - 3):
        post = abc.run_abc(ds, acfg, seed=seed, wave_runner=runner)
        theta, dist, waves = ref.posterior(c, seed, tol, 1000, 20, 40)
        assert waves == post.runs
        assert ref.mismatched_rows(post.theta, post.distances, theta, dist) == 0
        assert len(dist) >= 20


def test_mismatched_rows_counts_every_difference():
    theta = np.arange(12, dtype=np.float32).reshape(4, 3)
    dist = np.arange(4, dtype=np.float32)
    assert ref.mismatched_rows(theta, dist, theta, dist) == 0
    other = dist.copy()
    other[2] = np.nextafter(other[2], np.float32(9))
    assert ref.mismatched_rows(theta, dist, theta, other) == 1
    assert ref.mismatched_rows(theta[:3], dist[:3], theta, dist) == 1


@pytest.mark.parametrize("config", ["siard_italy"])
def test_frozen_counts_are_the_files(config):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    got = counting.counts(cfg)
    assert got["ops_per_sample_day"] == cfg["ops_per_sample_day"]
    assert got["ops_per_sample"] == cfg["ops_per_sample"]


@pytest.mark.parametrize("config,hand", [("siard_italy", 327.0), ("metapop_ring", 39300.0)])
def test_frozen_counts_near_the_hand_counts(config, hand):
    """The port's hand counts of a sample-day (`PERF.md`): within 2%."""
    assert abs(counting.counts(load(config))["ops_per_sample_day"] / hand - 1.0) < 0.02
