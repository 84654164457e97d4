"""The device wave loop's graph path on the card (marker `gpu`; skips
without one).

A `WaveRunner` on one card that has run one full segment eagerly captures
the next full segment as a CUDA graph and replays it for every later one
(`core.abc`). Each case holds the graph path to the eager path bit for bit:
the same accepted rows in the same order, the same waves, for SIARD at
100,000 x 49 (the flat kernel) and for Li et al. 2020's 375 cities at 2,000
x 14 (the tile route), in one-segment and two-segment posteriors; and each
route's wave entry to itself with its seeds read from device memory.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wave_graph_gpu.py
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import abc as tabc
from repro_torch.core.priors import schedule_prior
from repro_torch.epi import data, engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import EpiModelConfig, regionalize
from repro_torch.kernels import abc_sim, compact, ops

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

SEEDS = (3_000_000_011, 7, 2_147_483_659, 12_345, 99)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the port's kernels")
    return torch.device("cuda", 0)


def li2020(regions: int = 375):
    """li2020 over `regions` cities: a seeded traveller matrix (zero
    diagonal, 0-5,000 a day) and populations (0.2-3 million), Wuhan's part
    played by city regions // 3 (as tests/test_torch_regional_tile.py)."""
    rng = np.random.default_rng(regions)
    mob = (rng.random((regions, regions)) * 5e3 * (1 - np.eye(regions))).astype(np.float32)
    pops = rng.uniform(2e5, 3e6, regions).astype(np.float32)
    spec = regionalize(get_model("li2020"), regions, mob.tolist(), seed_region=regions // 3)
    return dataclasses.replace(spec, populations=tuple(float(x) for x in pops))


#: (dataset, spec, batch, days, quantile of the pilot): about 10 accepted a
#: wave at SIARD's, 20 at li2020's
CASES = ("siard", "li2020")
#: targets a case's posteriors reach in one segment (~5-10 waves) and in
#: two or more (~25 waves)
TARGETS = {"siard": (100, 250), "li2020": (100, 500)}


def _case(name: str):
    if name == "siard":
        return data.get_dataset("italy", num_days=49), get_model("siard"), 100_000, 49, 1e-4
    spec = li2020()
    cfg = EpiModelConfig(population=5e7, num_days=14, a0=1.0)
    theta = torch.tensor([spec.default_theta], dtype=torch.float32)
    observed = engine.simulate_observed(spec, theta, 11, cfg)[0].numpy()
    ds = data.CountryData(name="li2020_test", population=cfg.population, a0=1.0, r0=0.0, d0=0.0,
                          observed=observed, model=spec.name,
                          observed_channels=spec.observed_labels)
    return ds, spec, 2_000, 14, 1e-2


def _program(cuda, name: str, target: int):
    """(dataset, config, simulator) of a case at `target` accepted samples
    a posterior, the tolerance at the case's pilot quantile."""
    ds, spec, batch, days, quantile = _case(name)
    cfg = tabc.ABCConfig(batch_size=batch, chunk_size=batch, target_accepted=target,
                         max_runs=200, model=spec, num_days=days, wave_loop="device")
    sim = tabc.make_simulator(ds, cfg, cuda)
    tol = tabc.calibrate_tolerance(ds, cfg, seed=5, quantile=quantile, n_pilot=10 * batch,
                                   simulator=sim)
    return ds, dataclasses.replace(cfg, tolerance=tol), sim


def _runner(cfg, sim):
    return tabc.make_wave_runner(schedule_prior(get_model(cfg.model)), sim, cfg)


def _eager(ds, cfg, sim, seeds, monkeypatch, **kw):
    """Posteriors of `seeds` with the graph path shut."""
    with monkeypatch.context() as m:
        m.setattr(tabc.WaveRunner, "takes_graph", lambda self, max_waves: False)
        runner = _runner(cfg, sim)
        return [tabc.run_abc(ds, cfg, seed=s, wave_runner=runner, **kw) for s in seeds]


def _assert_same(a, b):
    assert (a.runs, a.simulations) == (b.runs, b.simulations)
    assert a.theta.shape == b.theta.shape and a.theta.shape[0] > 0
    np.testing.assert_array_equal(a.theta.view(np.int32), b.theta.view(np.int32))
    np.testing.assert_array_equal(a.distances.view(np.int32), b.distances.view(np.int32))


def _warm(ds, cfg, runner):
    """Two posteriors: the first's segment eager, the second's captured."""
    for s in (1, 2):
        tabc.run_abc(ds, cfg, seed=s, wave_runner=runner)
    assert runner._graph is not None and runner._graph.graph is not None


@pytest.mark.parametrize("name", CASES)
def test_graph_path_posteriors_are_the_eager_paths(cuda, monkeypatch, name):
    """Five one-segment posteriors on one runner (the first eager, the
    second captured, the rest replayed), and two-segment posteriors on a
    runner of a higher target (the first's second segment replayed from an
    eager segment's fill, then both replayed), bitwise the eager path's."""
    one, more = TARGETS[name]
    for target, seeds in ((one, SEEDS), (more, SEEDS[:3])):
        ds, cfg, sim = _program(cuda, name, target)
        want = _eager(ds, cfg, sim, seeds, monkeypatch)
        runner = _runner(cfg, sim)
        captures, replays = tabc.GRAPH_CAPTURES, tabc.GRAPH_REPLAYS
        got = [tabc.run_abc(ds, cfg, seed=s, wave_runner=runner) for s in seeds]
        for a, b in zip(got, want):
            _assert_same(a, b)
        segments = [-(-p.runs // tabc.SEGMENT_WAVES) for p in got]
        assert tabc.GRAPH_CAPTURES - captures == 1
        assert tabc.GRAPH_REPLAYS - replays == sum(segments) - 1
        if target == more:
            assert min(segments) >= 2, [p.runs for p in got]
        else:
            assert max(segments) == 1, [p.runs for p in got]


def test_a_graph_keeps_status_words_of_its_own(cuda, monkeypatch):
    """The graph's compactions take status words that only the runner
    holds: after the capture every (device, stream)'s words are replaced by
    larger ones, the old freed and their memory taken by tensors of -1, and
    the replays still give the eager path's posteriors."""
    ds, cfg, sim = _program(cuda, "siard", 100)
    want = _eager(ds, cfg, sim, SEEDS[:3], monkeypatch)
    runner = _runner(cfg, sim)
    _warm(ds, cfg, runner)
    words = runner._graph.words
    assert all(w.data_ptr() != words.data_ptr() for w in compact._WORDS.values())
    sizes = [w.numel() for w in compact._WORDS.values()]
    for key, n in zip(list(compact._WORDS), sizes):
        compact._WORDS[key] = torch.zeros((4 * n,), dtype=torch.int64, device=cuda)
    junk = [torch.full((n,), -1, dtype=torch.int64, device=cuda) for n in sizes for _ in range(64)]
    replays = tabc.GRAPH_REPLAYS
    got = [tabc.run_abc(ds, cfg, seed=s, wave_runner=runner) for s in SEEDS[:3]]
    assert tabc.GRAPH_REPLAYS - replays == 3 and len(junk) == 64 * len(sizes)
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_resumed_state_and_short_segments_take_the_eager_path(cuda, monkeypatch, tmp_path):
    """On a runner that replays, a resumed state (its rows in buffers of
    its own) and segments cut by `checkpoint_every` run eagerly, bitwise as
    before, and replay nothing."""
    ds, cfg, sim = _program(cuda, "siard", 100)
    runner = _runner(cfg, sim)
    _warm(ds, cfg, runner)
    half = tabc.run_abc(ds, dataclasses.replace(cfg, max_runs=4), seed=21, wave_runner=runner)
    assert 0 < half.theta.shape[0] < cfg.target_accepted

    def resumed():
        return tabc.ABCState(run_idx=half.runs, simulations=half.simulations,
                             accepted_theta=[half.theta.copy()],
                             accepted_dist=[half.distances.copy()], n_params=half.theta.shape[1])

    (want_resumed,) = _eager(ds, cfg, sim, (21,), monkeypatch, state=resumed())
    path = str(tmp_path / "state.npz")
    (want_cut,) = _eager(ds, cfg, sim, (22,), monkeypatch, checkpoint_every=5,
                         checkpoint_path=path)
    replays = tabc.GRAPH_REPLAYS
    got_resumed = tabc.run_abc(ds, cfg, seed=21, wave_runner=runner, state=resumed())
    got_cut = tabc.run_abc(ds, cfg, seed=22, wave_runner=runner, checkpoint_every=5,
                           checkpoint_path=path)
    assert tabc.GRAPH_REPLAYS == replays
    _assert_same(got_resumed, want_resumed)
    _assert_same(got_cut, want_cut)
    # and the runner replays again on the next fresh posterior
    tabc.run_abc(ds, cfg, seed=23, wave_runner=runner)
    assert tabc.GRAPH_REPLAYS == replays + 1


def test_a_replay_counts_its_launches_and_one_sync(cuda):
    """One replay moves the wave entry's and the compaction's launch counts
    by SEGMENT_WAVES each, HOST_SYNCS and GRAPH_REPLAYS by one; a runner
    captures once, and another runner once more."""
    ds, cfg, sim = _program(cuda, "siard", 100)
    name = sim.entry("wave", cfg.batch_size)
    captures = tabc.GRAPH_CAPTURES
    runner = _runner(cfg, sim)
    _warm(ds, cfg, runner)
    assert tabc.GRAPH_CAPTURES == captures + 1
    before = (abc_sim.ENTRY_LAUNCHES[name], tabc.COMPACT_KERNEL_LAUNCHES, tabc.HOST_SYNCS,
              tabc.GRAPH_REPLAYS, abc_sim.ENTRY_GATED.get(name, 0))
    post = tabc.run_abc(ds, cfg, seed=31, wave_runner=runner)
    after = (abc_sim.ENTRY_LAUNCHES[name], tabc.COMPACT_KERNEL_LAUNCHES, tabc.HOST_SYNCS,
             tabc.GRAPH_REPLAYS, abc_sim.ENTRY_GATED.get(name, 0))
    w = tabc.SEGMENT_WAVES
    assert post.runs <= w
    assert tuple(b - a for a, b in zip(before, after)) == (w, w, 1, 1, w - post.runs)
    _warm(ds, cfg, _runner(cfg, sim))
    assert tabc.GRAPH_CAPTURES == captures + 2


def test_no_host_sync_between_replay_and_read(cuda):
    """`init` of an empty state and a replayed segment enqueue under
    set_sync_debug_mode("error"); `read` then waits once."""
    ds, cfg, sim = _program(cuda, "siard", 100)
    runner = _runner(cfg, sim)
    _warm(ds, cfg, runner)
    state = tabc.ABCState(n_params=runner.n_params)
    replays = tabc.GRAPH_REPLAYS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = runner.init(state)
        out = runner(41, 0, carry, tabc.SEGMENT_WAVES)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tabc.GRAPH_REPLAYS == replays + 1 and out.counts is not None
    waves, n, fill = runner.read(out)
    runner.harvest(out, state, fill)
    want = tabc.run_abc(ds, cfg, seed=41, wave_runner=_runner(cfg, sim))
    assert (waves, n) == (want.runs, state.n_accepted)
    np.testing.assert_array_equal(np.concatenate(state.accepted_theta), want.theta)


#: the wave entries of each route: (model, route, batch, days)
ROUTES = [("siard", None, 100_000, 49), ("metapop_seir", "thread", 20_000, 49),
          ("metapop_seir", "warp", 20_000, 49), ("li2020", "tile", 2_000, 14)]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: f"{c[0]}-{c[1] or 'flat'}")
def test_wave_entry_reads_its_seeds_from_device_memory(cuda, case):
    """A wave entry handed its (simulation, prior) seeds in device memory,
    with other seeds in its parameters, writes bitwise the theta and
    distances of a launch with those seeds in its parameters."""
    model, route, batch, days = case
    if model == "li2020":
        spec = li2020()
        cfg = EpiModelConfig(population=5e7, num_days=days, a0=1.0)
        theta = torch.tensor([spec.default_theta], dtype=torch.float32)
        observed = engine.simulate_observed(spec, theta, 11, cfg)[0]
        kw = dict(population=cfg.population, a0=1.0, r0=0.0, d0=0.0)
    else:
        spec = get_model(model)
        ds = data.get_dataset("italy" if model == "siard" else "synthetic_small",
                              num_days=days, model=spec)
        observed = torch.as_tensor(ds.observed)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    sim = ops.make_abc_sim(observed.to(cuda), model=spec, **kw)
    ln = sim.launch("wave", batch, route)
    assert ln.route == (route or "flat")
    prior = spec.prior()
    for sim_seed, prior_seed in ((77, 12), (2**32 - 1, 2**31 + 5)):
        want = ln(sim_seed, prior_seed, prior.lows, prior.highs)
        seeds = torch.tensor(np.array([sim_seed, prior_seed], np.uint32).view(np.int32),
                             device=cuda)
        got = ln(sim_seed ^ 0x5A5A, prior_seed ^ 0xA5A5, prior.lows, prior.highs, seeds=seeds)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
