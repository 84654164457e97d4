"""The port's span recorder (`repro_torch.runtime.trace`) and the spans of
the ABC loops (`core.abc`): off, a span is one shared object and no clock is
read; on, a device-loop posterior at 2,000 samples a wave at the 1e-2
quantile records one `abc.posterior`, one `abc.init`, one `abc.sync` a
segment (as many as `HOST_SYNCS` counts), one `abc.wave` a wave enqueued
and one `abc.compact` inside each, all under the posterior's request id,
and gives the accepted set of an untraced run bit for bit. The spans are on
the clock of `torch.profiler`'s events."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import abc
from repro_torch.epi.data import get_dataset
from repro_torch.runtime import trace

torch.set_num_threads(1)

DAYS = 12
BATCH = 2000


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def problem():
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = abc.ABCConfig(batch_size=BATCH, chunk_size=BATCH, target_accepted=60,
                        max_runs=40, num_days=DAYS, wave_loop="device")
    tol = abc.calibrate_tolerance(ds, cfg, seed=7, quantile=1e-2, n_pilot=4 * BATCH,
                                  device="cpu")
    return ds, dataclasses.replace(cfg, tolerance=tol)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def test_off_is_one_shared_object_and_records_nothing(problem, monkeypatch):
    reads = []
    monkeypatch.setattr(trace, "_clock", lambda: reads.append(1) or 0)
    assert trace.span("abc.wave") is trace.span("abc.sync") is trace.OFF
    ds, cfg = problem
    post = abc.run_abc(ds, cfg, seed=3, device="cpu")
    assert post.runs >= 2
    assert trace.records() == [] and reads == []


def test_on_reads_two_clocks_a_span(problem, monkeypatch):
    ds, cfg = problem
    now = iter(range(10**9))
    monkeypatch.setattr(trace, "_clock", lambda: next(now))
    trace.enable()
    abc.run_abc(ds, cfg, seed=3, device="cpu")
    spans = trace.records()
    assert spans and next(now) == 2 * len(spans)
    assert all(s[1] < s[2] for s in spans)


@pytest.mark.parametrize("checkpoint_every", [0, 2])
def test_device_loop_spans(problem, tmp_path, checkpoint_every):
    ds, cfg = problem
    trace.enable()
    syncs = abc.HOST_SYNCS
    post = abc.run_abc(ds, cfg, seed=5, device="cpu", checkpoint_every=checkpoint_every,
                       checkpoint_path=str(tmp_path / "state.npz"))
    syncs = abc.HOST_SYNCS - syncs
    spans = trace.records()
    names = _by_name(spans)
    assert len(post) >= cfg.target_accepted
    assert set(names) == {"abc.posterior", "abc.init", "abc.segment", "abc.wave",
                          "abc.compact", "abc.sync", "abc.harvest"}
    assert len(names["abc.posterior"]) == len(names["abc.init"]) == 1
    segment = checkpoint_every or abc.SEGMENT_WAVES
    assert syncs == len(names["abc.sync"]) == len(names["abc.segment"]) \
        == len(names["abc.harvest"]) == -(-post.runs // segment)
    # every wave enqueued, gated ones included, and one compaction in each
    assert len(names["abc.wave"]) == len(names["abc.compact"]) == segment * syncs
    waves = {s[3]: s for s in names["abc.wave"]}
    segments = {s[3] for s in names["abc.segment"]}
    assert all(w[4] in segments for w in waves.values())
    for c in names["abc.compact"]:
        w = waves[c[4]]
        assert w[1] <= c[1] <= c[2] <= w[2]
    (root,) = names["abc.posterior"]
    assert root[4] == 0
    assert {s[5] for s in spans} == {root[3]}
    assert all(root[1] <= s[1] <= s[2] <= root[2] for s in spans)


def test_host_loop_spans(problem):
    ds, cfg = problem
    trace.enable()
    post = abc.run_abc(ds, dataclasses.replace(cfg, wave_loop="host"), seed=5,
                       device="cpu")
    names = _by_name(trace.records())
    assert set(names) == {"abc.posterior", "abc.harvest"}
    assert len(names["abc.harvest"]) == post.runs
    (root,) = names["abc.posterior"]
    assert all(s[4] == s[5] == root[3] for s in names["abc.harvest"])


def test_request_ids_part_posteriors(problem):
    ds, cfg = problem
    trace.enable()
    for seed in (1, 2):
        abc.run_abc(ds, cfg, seed=seed, device="cpu")
    spans = trace.records()
    roots = [s[3] for s in spans if s[0] == "abc.posterior"]
    assert len(roots) == 2 and sorted({s[5] for s in spans}) == sorted(roots)
    trace.clear()
    assert trace.records() == []


def test_tracing_leaves_the_accepted_set(problem):
    ds, cfg = problem
    off = abc.run_abc(ds, cfg, seed=11, device="cpu")
    trace.enable()
    on = abc.run_abc(ds, cfg, seed=11, device="cpu")
    assert trace.records()
    assert (on.runs, on.simulations) == (off.runs, off.simulations)
    np.testing.assert_array_equal(on.theta, off.theta)
    np.testing.assert_array_equal(on.distances, off.distances)


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("mm"):
                a @ a
    (mm,) = [s for s in trace.records() if s[0] == "mm"]
    (outer,) = [s for s in trace.records() if s[0] == "outer"]
    assert mm[4] == outer[3] and mm[5] == outer[5] == outer[3]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops
    assert all(mm[1] <= e.start_ns() <= mm[2] for e in ops)
