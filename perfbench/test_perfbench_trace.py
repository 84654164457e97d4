"""The program's spans laid over a device timeline (`program_spans.py`): on
synthetic launches and device intervals, the seconds and launches each span
is given, nested spans, a launch outside every span and a device interval
whose launch is missing; the idle gaps by span. Then a whole run of a cell
on the CPU at a tiny size with the program's tracing on stays correct and
reads `wave_enqueue_us`, and a run of the harness leaves the program's
tracing off."""

import time

import pytest
import torch

from perfbench import harness, program_spans as ps
from perfbench.test_perfbench_faults import CELL, small
from repro_torch.runtime import trace as rt

NS = 1e-9
#: (name, start, end, id, parent, request): a posterior, two waves (the
#: first with a compaction inside), a sync between them
SPANS = [
    ("abc.compact", 120, 130, 3, 2, 1),
    ("abc.wave", 110, 140, 2, 1, 1),
    ("abc.sync", 150, 160, 4, 1, 1),
    ("abc.wave", 170, 190, 5, 1, 1),
    ("abc.posterior", 100, 1000, 1, 0, 1),
]
#: (start, end, name, correlation id); 6 has no launch in the profile
DEVICE = [(100, 110, "k", 7), (140, 145, "k", 1), (165, 185, "idx", 2), (185, 195, "copy", 3),
          (195, 205, "k", 4), (205, 210, "k", 5), (210, 220, "k", 6)]
#: correlation id -> the launch's host ns; 5 launched before the posterior
LAUNCHES = {7: 105, 1: 115, 2: 125, 3: 155, 4: 175, 5: 50}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_innermost():
    got = ps.innermost(SPANS, [50, 100, 115, 125, 130, 145, 155, 180, 500, 1001])
    assert [None if s is None else s[3] for s in got] == [None, 1, 2, 3, 3, 1, 4, 5, 1, None]


def test_launches_put_down_to_spans():
    p = ps.attribute(DEVICE, LAUNCHES, SPANS, 100, 1100)
    approx = pytest.approx
    assert p["device_s"] == approx({"abc.posterior": 10 * NS, "abc.wave": 15 * NS,
                                    "abc.compact": 20 * NS, "abc.sync": 10 * NS,
                                    ps.OUTSIDE: 5 * NS, ps.UNMATCHED: 10 * NS})
    assert p["launches"] == {"abc.posterior": 1, "abc.wave": 2, "abc.compact": 1,
                             "abc.sync": 1, ps.OUTSIDE: 1, ps.UNMATCHED: 1}
    assert p["device_s_inside"] == approx({"abc.posterior": 55 * NS, "abc.wave": 35 * NS,
                                           "abc.compact": 20 * NS, "abc.sync": 10 * NS})
    assert p["launches_inside"] == {"abc.posterior": 5, "abc.wave": 3, "abc.compact": 1,
                                    "abc.sync": 1}
    assert p["device_total_s"] == approx(70 * NS)
    assert sum(p["device_s"].values()) == approx(p["device_total_s"])
    assert p["device_s_by_op"]["idx"] == approx({"abc.compact": 20 * NS})
    # gaps 110-140 (midpoint in the compaction), 145-165 (in the sync) and
    # 220-1100 (in the posterior)
    assert p["idle_s"] == approx({"abc.compact": 30 * NS, "abc.sync": 20 * NS,
                                  "abc.posterior": 880 * NS})
    assert p["spans"] == {"abc.posterior": [1, approx(900 * NS)],
                          "abc.wave": [2, approx(50 * NS)],
                          "abc.compact": [1, approx(10 * NS)],
                          "abc.sync": [1, approx(10 * NS)]}
    assert ps.readings(p) == approx({"wave_enqueue_us": 0.025, "launches_per_wave": 1.5,
                                     "compaction_ms_per_posterior": 2e-5,
                                     "sync_idle_ms_per_posterior": 2e-5})


def test_window_bounds_the_spans_and_the_gaps():
    p = ps.attribute(DEVICE, LAUNCHES, SPANS, 150, 250)
    assert p["spans"] == {"abc.sync": [1, pytest.approx(10 * NS)],
                          "abc.wave": [1, pytest.approx(20 * NS)]}
    # the gap from the window's start to the first interval is the sync's
    assert p["idle_s"]["abc.sync"] == pytest.approx(15 * NS)
    assert ps.readings(p) == pytest.approx({"wave_enqueue_us": 0.02,
                                            "launches_per_wave": 3.0})


def test_no_device_work_reads_the_host_only():
    p = ps.attribute([], {}, SPANS, 100, 1100)
    assert p["device_total_s"] == 0
    assert p["idle_s"] == pytest.approx({"abc.posterior": 1000 * NS})
    assert set(ps.readings(p)) == {"wave_enqueue_us"}


class _Event:
    def __init__(self, kind, start, dur, corr, name="op"):
        self.kind, self.start, self.dur, self.corr, self._name = kind, start, dur, corr, name

    def activity_type(self):
        return self.kind

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def name(self):
        return self._name


class _Unnamed(_Event):
    """An event of a profiler that does not name its activity."""

    activity_type = None

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.kind == "kernel" else DeviceType.CPU


def test_profile_events_clip_the_device_and_keep_every_launch():
    events = [_Event("cuda_runtime", 10, 3, 1), _Event("kernel", 20, 10, 1, "k"),
              _Event("cuda_driver", 30, 2, 2), _Event("gpu_memcpy", 95, 10, 2, "c"),
              _Event("kernel", 200, 5, 3, "late"), _Event("cpu_op", 40, 5, 4),
              _Event("overhead", 45, 1, 0)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    device, launches = ps.profile_events(Prof, 0, 100)
    assert device == [(20, 30, "k", 1), (95, 100, "c", 2)]
    assert launches == {1: 10, 2: 30}
    # without the activity, a launch is known by its call's name
    events[:] = [_Unnamed("cpu", 10, 3, 1, "cudaLaunchKernel"), _Unnamed("kernel", 20, 10, 1, "k"),
                 _Unnamed("cpu", 12, 1, 5, "Activity Buffer Request")]
    device, launches = ps.profile_events(Prof, 0, 100)
    assert device == [(20, 30, "k", 1)] and launches == {1: 10}


def _run(trace):
    return harness.run_cell(CELL, 2**31 + 29, 0.3, trace, time.time(), device_type="cpu")


def test_traced_cpu_run_reads_the_wave_and_stays_correct(monkeypatch):
    small(monkeypatch)
    rt.clear()
    rt.enable()
    try:
        result = _run(trace=True)
        spans = rt.records()
    finally:
        rt.disable()
        rt.clear()
    assert result["correct"] and all(c["value"] == 0 for c in result["checks"].values())
    p = ps.attribute([], {}, spans, min(s[1] for s in spans), max(s[2] for s in spans))
    # the window's posteriors and the one warm-up posterior
    assert p["spans"]["abc.posterior"][0] == result["attempted"] + 1
    assert ps.readings(p)["wave_enqueue_us"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_leaves_the_programs_tracing_off(monkeypatch, trace):
    small(monkeypatch)
    result = _run(trace)
    assert result["correct"]
    assert rt.span("abc.wave") is rt.OFF and rt.records() == []
