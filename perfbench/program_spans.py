"""The program's own spans (`repro_torch.runtime.trace`) laid over the
profiler's device timeline of a traced window.

The profiler's CUDA activity holds, beside each kernel, copy and fill, the
runtime or driver call that launched it (`cudaLaunchKernel`,
`cudaMemcpyAsync`, ...): a host timestamp with the same correlation id as
the device interval. The innermost program span that covers that host time
names the device interval; each idle gap of the card is named, as
`trace.summarize` names it from the benchmark's own spans, by the innermost
program span at its midpoint. Both clocks are the wall clock in ns.

Spans are the recorder's tuples (name, start_ns, end_ns, span_id,
parent_id, request_id) of one thread: spans of one thread nest, which the
sweep in `innermost` relies on.

`harness.window` does not call this yet; a traced run that enables the
program's tracing for its window and keeps `records()` can hand them here
with the profile, and `readings` gives the per-layer numbers.
"""

from __future__ import annotations

from collections import defaultdict

from perfbench.trace import _on_device

#: the host calls that launch device work, by the profiler's activity type
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")
#: the name of host time that no program span covers
OUTSIDE = "outside program spans"
#: the name of a device interval whose launch the profile does not hold
UNMATCHED = "launch not seen"


def _is_launch(e) -> bool:
    """A runtime or driver call: by the event's activity where the profiler
    names it, else by its name (`cudaLaunchKernel`, `cuLaunchKernel`, ...)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in LAUNCH_ACTIVITIES
    return e.name().startswith("cu")


def profile_events(prof, t0_ns: int, t1_ns: int):
    """(device, launches) of a stopped `torch.profiler.profile`: device is
    [(start ns, end ns, name, correlation id)] clipped to the window, sorted;
    launches maps a correlation id to its launch's host start ns."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if _on_device(e):
            a = e.start_ns()
            a, b = max(a, t0_ns), min(a + e.duration_ns(), t1_ns)
            if b > a:
                device.append((a, b, e.name(), e.correlation_id()))
        elif _is_launch(e) and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    device.sort()
    return device, launches


def innermost(spans, times):
    """For each of `times` (ascending), the innermost of `spans` that covers
    it, or None."""
    order = sorted(spans, key=lambda s: (s[1], -s[2], s[3]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(order) and order[k][1] <= t:
            s = order[k]
            k += 1
            while stack and stack[-1][2] < s[1]:
                stack.pop()
            stack.append(s)
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def attribute(device, launches: dict, spans, t0_ns: int, t1_ns: int) -> dict:
    """The window's work by program span.

    - `spans`: {name: [count, host seconds]} of the spans that start in the
      window;
    - `device_s`, `launches`: device seconds and activities by the innermost
      span around their launch (`OUTSIDE` where none, `UNMATCHED` where the
      profile holds no launch);
    - `device_s_inside`, `launches_inside`: the same for every span name
      around the launch, children's included;
    - `device_s_by_op`: {operation: {innermost span: device seconds}};
    - `idle_s`: the card's idle seconds by the innermost span at each gap's
      midpoint;
    - `device_total_s`: the device seconds of the window."""
    by_id = {s[3]: s for s in spans}
    out = {k: defaultdict(float) for k in ("device_s", "launches", "device_s_inside",
                                            "launches_inside", "idle_s")}
    by_op = defaultdict(lambda: defaultdict(float))
    total = 0.0
    device = sorted(device)
    matched = sorted((launches[c], (b - a) / 1e9, name)
                     for a, b, name, c in device if c in launches)
    for (_, sec, op), s in zip(matched, innermost(spans, [m[0] for m in matched])):
        own = OUTSIDE if s is None else s[0]
        out["device_s"][own] += sec
        out["launches"][own] += 1
        by_op[op][own] += sec
        names = set()
        while s is not None:
            names.add(s[0])
            s = by_id.get(s[4])
        for n in names:
            out["device_s_inside"][n] += sec
            out["launches_inside"][n] += 1
    for a, b, name, c in device:
        total += (b - a) / 1e9
        if c not in launches:
            out["device_s"][UNMATCHED] += (b - a) / 1e9
            out["launches"][UNMATCHED] += 1
            by_op[name][UNMATCHED] += (b - a) / 1e9
    gaps, edge = [], t0_ns
    for a, b, _, _ in device:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if t1_ns > edge:
        gaps.append((edge, t1_ns))
    for (a, b), s in zip(gaps, innermost(spans, [(a + b) / 2 for a, b in gaps])):
        out["idle_s"][OUTSIDE if s is None else s[0]] += (b - a) / 1e9
    counts = defaultdict(lambda: [0, 0.0])
    for s in spans:
        if t0_ns <= s[1] <= t1_ns:
            counts[s[0]][0] += 1
            counts[s[0]][1] += (s[2] - s[1]) / 1e9
    summary = {k: dict(v) for k, v in out.items()}
    summary.update(spans=dict(counts), device_s_by_op={k: dict(v) for k, v in by_op.items()},
                   device_total_s=total)
    return summary


def readings(program: dict) -> dict:
    """The per-layer numbers of an `attribute` summary: `wave_enqueue_us`
    (mean host time of an `abc.wave`), and where the window had device work
    `launches_per_wave` (device activities launched inside `abc.wave` over
    the waves), `compaction_ms_per_posterior` (device ms launched inside
    `abc.compact` over the posteriors) and `sync_idle_ms_per_posterior` (idle
    ms whose gap's midpoint lies in `abc.sync`, over the posteriors)."""
    waves, wave_s = program["spans"].get("abc.wave", (0, 0.0))
    posteriors = program["spans"].get("abc.posterior", (0, 0.0))[0]
    out = {}
    if waves:
        out["wave_enqueue_us"] = wave_s / waves * 1e6
    if program["device_total_s"] > 0:
        if waves:
            out["launches_per_wave"] = program["launches_inside"].get("abc.wave", 0) / waves
        if posteriors:
            out["compaction_ms_per_posterior"] = (
                program["device_s_inside"].get("abc.compact", 0.0) * 1e3 / posteriors)
            out["sync_idle_ms_per_posterior"] = (
                program["idle_s"].get("abc.sync", 0.0) * 1e3 / posteriors)
    return out
