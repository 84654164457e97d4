"""The traced run: the benchmark's own host spans and the profiler's device
timeline of the card, reduced to what the per-layer metrics read.

Host spans are kept in memory as (level, name, start ns, end ns) on the
wall clock that the profiler's events use. Level 0 is a posterior (the
call of `run_abc`), level 1 a call into the wave loop inside it, made
through `SpannedRunner`. The device timeline is every kernel, copy and fill
that the profiler saw (CUDA activity only, so the host's own operations
cost nothing to record).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

#: the device activities that make the card busy
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: a gap's name when no span covers it: the harness between posteriors
BETWEEN = "between posteriors"


class Spans:
    def __init__(self):
        self.levels = defaultdict(list)

    def record(self, level: int, name: str, start_ns: int, end_ns: int) -> None:
        self.levels[level].append((start_ns, end_ns, name))

    def name_at(self, t_ns: float) -> str:
        """The innermost span that covers `t_ns`."""
        for level in sorted(self.levels, reverse=True):
            spans = self.levels[level]
            k = bisect.bisect_right(spans, (t_ns, float("inf"), "")) - 1
            if k >= 0 and spans[k][0] <= t_ns <= spans[k][1]:
                return spans[k][2]
        return BETWEEN


class SpannedRunner:
    """A wave loop whose calls from `run_abc` are recorded as level-1 spans:
    `init` (the posterior's buffers), `enqueue` (a segment of waves),
    `read` (the segment's one host sync), `harvest` (the accepted rows to
    the host) and `carry` (the next segment's carry)."""

    def __init__(self, runner, spans: Spans):
        self._runner, self._spans = runner, spans

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _timed(self, name, fn, *args):
        t0 = time.time_ns()
        try:
            return fn(*args)
        finally:
            self._spans.record(1, name, t0, time.time_ns())

    def init(self, state):
        return self._timed("init", self._runner.init, state)

    def __call__(self, *args):
        return self._timed("enqueue", self._runner, *args)

    def read(self, out):
        return self._timed("read", self._runner.read, out)

    def harvest(self, *args):
        return self._timed("harvest", self._runner.harvest, *args)

    def carry_of(self, out):
        return self._timed("carry", self._runner.carry_of, out)


def _on_device(e) -> bool:
    """A kernel, copy or fill: by the event's activity where the profiler
    names it, else by the device it ran on."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA


def device_intervals(prof, t0_ns: int, t1_ns: int):
    """[(start ns, end ns, name)] of the device's activities clipped to the
    window, from a stopped `torch.profiler.profile`."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not _on_device(e):
            continue
        a = e.start_ns()
        a, b = max(a, t0_ns), min(a + e.duration_ns(), t1_ns)
        if b > a:
            out.append((a, b, e.name()))
    out.sort()
    return out


def summarize(intervals, t0_ns: int, t1_ns: int, spans: Spans) -> dict:
    """What the per-layer metrics read: the window, the union of the
    device intervals (busy), device seconds by operation name, and the idle
    gaps' seconds by what the host was doing."""
    by_name, gaps = defaultdict(float), defaultdict(float)
    busy_ns, edge = 0, t0_ns
    for a, b, name in intervals:
        by_name[name] += (b - a) / 1e9
        if a > edge:
            gaps[spans.name_at((edge + a) / 2)] += (a - edge) / 1e9
            busy_ns, edge = busy_ns + b - a, b
        elif b > edge:
            busy_ns, edge = busy_ns + b - edge, b
    if t1_ns > edge:
        gaps[spans.name_at((edge + t1_ns) / 2)] += (t1_ns - edge) / 1e9
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy_ns / 1e9,
            "device_s": dict(by_name), "idle_s": dict(gaps)}


#: characters of an operation's name in the breakdown (a kernel's full
#: signature runs to a thousand)
NAME_CHARS = 120


def top(d: dict, n: int = 10):
    """The n largest entries, as [name, seconds]."""
    return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
