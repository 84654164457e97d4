"""Wave-loop auditor over every registered ABC combination (port of
`repro.analysis.trace_audit`).

For each (model x summary x distance x schedule shape) combo this pass runs
the device wave loop (`core.abc.WaveRunner`) on the CPU, at a small size,
under a dispatch recorder that sees every aten operation, and checks the
contracts the campaign runner and the card's numbers rely on. A combo of
style "pjit" runs the pjit device loop (`core.distributed.PjitWaveRunner`)
instead, in a world of 1 over gloo: its count all-reduce a wave and its
gather and placement of the rows at the host re-entry are under the same
checks.

  f64-promotion           no float64 tensor is produced in a segment: the
                          stack is float32 by contract; a float64 leak
                          doubles the traffic and on the card leaves the
                          CUDA cores' float32 rate.
  host-sync-in-segment    the `_local_scalar_dense` calls (an .item(), an
                          int() of a tensor) and host copies of a segment's
                          enqueue and read are no more than the loop's
                          contract of one host sync a segment (the
                          counterpart of `repro`'s host-transfer-under-jit).
                          The read of `core.abc.sync_counts` is that one
                          sync however many counts it copies.
  buffer-not-reused       the accept buffers (theta_buf, dist_buf) keep
                          their storage across two segments, and a wave
                          allocates no float32 tensor of the wave's theta or
                          distance shape: those go to buffers made once a
                          call (the counterpart of `repro`'s
                          non-donated-buffer). The compaction's masks and
                          indices are its working set, as XLA's temporaries
                          are, and are not counted.
  shape-cache-retrace     two scenarios that the campaign's `_ShapeCache`
                          maps to one key share one entry, and their
                          simulators present the same shapes and dtypes.
  audit-trace-error       a registered combo failed to run at all.

What the simulator does inside a wave is the kernel's on the card; on the
CPU its plain version stands in for it (`ops.AbcSim.wave` and `__call__`),
so host syncs and allocations there (the CPU reads its gate on the host)
are not the loop's and are not counted. Its float64 tensors are counted:
the plain version is the kernel's reference.

Dropped: `repro`'s weak-type-leak. Torch has no weak types: a Python
scalar meets a tensor at the tensor's dtype and leaves nothing behind.

The checks are pure functions of what the recorder saw (`audit_dtypes`,
`audit_syncs`, `audit_buffers`, `audit_shape_cache`), so the tests plant
violations straight into them.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding

AUDIT_RULES: Dict[str, str] = {
    "shape-cache-retrace": (
        "scenarios sharing a _ShapeCache key take another entry or present "
        "other shapes or dtypes — the 'one entry per shape' contract is broken"
    ),
    "f64-promotion": (
        "a float64 tensor in a device-loop segment (the stack is float32 by "
        "contract)"
    ),
    "host-sync-in-segment": (
        "a device-loop segment reads the device more than its contract of one "
        "host sync a segment"
    ),
    "buffer-not-reused": (
        "the accept buffers move between segments, or a wave allocates a "
        "float32 tensor of the wave's theta or distance shape"
    ),
    "audit-trace-error": (
        "a registered combo failed to run at all"
    ),
}

#: aten operations that bring a device value to the host
_HOST_READS = frozenset({"_local_scalar_dense"})
_COPIES = frozenset({"_to_copy", "copy_", "copy"})


class Event(NamedTuple):
    """One aten operation as the recorder saw it."""

    op: str
    dtypes: Tuple[str, ...]  # of its tensor outputs
    shapes: Tuple[Tuple[int, ...], ...]
    #: "loop" (the wave loop's own code), "kernel" (the simulator, which is a
    #: kernel on the card) or "read" (core.abc.sync_counts)
    scope: str
    sync: bool  # a host read or a copy to the host
    allocates: bool  # an output whose storage none of the inputs holds


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _scope_codes():
    from repro_torch.core import abc
    from repro_torch.kernels import ops

    kernel = {ops.AbcSim.wave.__code__, ops.AbcSim.__call__.__code__}
    return kernel, {abc.sync_counts.__code__}


class DispatchRecorder(TorchDispatchMode):
    """Records every aten operation run under it as an `Event`, with the
    scope the Python stack puts it in."""

    def __init__(self):
        super().__init__()
        self.events: List[Event] = []
        self._kernel, self._read = _scope_codes()

    def _scope(self) -> str:
        frame = sys._getframe(2)
        while frame is not None:
            if frame.f_code in self._kernel:
                return "kernel"
            if frame.f_code in self._read:
                return "read"
            frame = frame.f_back
        return "loop"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = list(_tensors(out))
        ins = list(_tensors((args, kwargs)))
        held = {t.untyped_storage().data_ptr() for t in ins}
        allocates = any(t.untyped_storage().data_ptr() not in held for t in outs)
        sync = name in _HOST_READS or (
            name in _COPIES and any(t.device.type == "cpu" for t in outs)
            and any(t.device.type != "cpu" for t in ins))
        self.events.append(Event(
            op=name, dtypes=tuple(str(t.dtype) for t in outs),
            shapes=tuple(tuple(t.shape) for t in outs), scope=self._scope(), sync=sync,
            allocates=allocates))
        return out


# ---------------------------------------------------------------------------
# generic, pure checkers (driven by run_audit AND the planted tests)
# ---------------------------------------------------------------------------

def audit_dtypes(events: Sequence[Event], context: str) -> List[Finding]:
    """f64-promotion: one finding for the first float64 tensor produced."""
    for e in events:
        if "torch.float64" in e.dtypes:
            return [Finding(rule="f64-promotion", path="-", line=0, context=context,
                            message=f"aten {e.op} produces a float64 tensor "
                                    f"({e.scope} code)")]
    return []


def audit_syncs(events: Sequence[Event], reads: int, segments: int,
                context: str) -> List[Finding]:
    """host-sync-in-segment: the segments' `reads` (calls of
    `core.abc.sync_counts`) plus every other host read or copy outside the
    simulator must be at most one a segment."""
    stray = [e for e in events if e.sync and e.scope == "loop"]
    if reads + len(stray) <= segments:
        return []
    ops = sorted({e.op for e in stray})
    return [Finding(rule="host-sync-in-segment", path="-", line=0, context=context,
                    message=f"{reads} count reads and {len(stray)} other host reads "
                            f"({', '.join(ops) or 'none'}) in {segments} segment(s); the "
                            "contract is one host sync a segment")]


def wave_buffer_allocations(events: Sequence[Event], batch: int, width: int) -> int:
    """Allocations of the loop's own code of a float32 tensor of a wave's
    theta shape [batch, width] or distance shape [batch]."""
    shapes = {(batch, width), (batch,)}
    return sum(1 for e in events if e.allocates and e.scope == "loop"
               for dt, sh in zip(e.dtypes, e.shapes) if dt == "torch.float32" and sh in shapes)


def audit_buffers(buffer_ptrs: Sequence[Tuple[int, ...]], allocations: Dict[int, int],
                  context: str) -> List[Finding]:
    """buffer-not-reused: `buffer_ptrs` holds the accept buffers' data
    pointers after each segment, which must not move; `allocations` maps a
    segment's wave count to its wave-buffer allocations
    (`wave_buffer_allocations`), which must not grow with the waves."""
    findings = []
    if len(set(buffer_ptrs)) > 1:
        findings.append(Finding(
            rule="buffer-not-reused", path="-", line=0, context=context,
            message=f"the accept buffers moved between segments ({len(set(buffer_ptrs))} "
                    "addresses): a segment copies them instead of writing in place"))
    counts = [allocations[w] for w in sorted(allocations)]
    if any(b > a for a, b in zip(counts, counts[1:])):
        findings.append(Finding(
            rule="buffer-not-reused", path="-", line=0, context=context,
            message=f"wave-sized float32 allocations grow with the waves "
                    f"({dict(sorted(allocations.items()))} by waves a segment): a wave "
                    "allocates its buffers instead of reusing them"))
    return findings


def _signature(tree) -> List:
    """Structure and leaf (shape, dtype) of a nested dict/list/tuple of
    tensors, arrays and scalars."""
    if isinstance(tree, dict):
        return ["dict"] + [[k] + _signature(v) for k, v in sorted(tree.items())]
    if isinstance(tree, (list, tuple)):
        return [f"seq{len(tree)}"] + [_signature(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype))]
    if isinstance(tree, np.ndarray):
        return [(tree.shape, str(tree.dtype))]
    return [type(tree).__name__]


def audit_shape_cache(variants: Sequence, context: str, entries: int = 1) -> List[Finding]:
    """Scenario variants meant to share ONE shape-cache entry must have made
    `entries` == 1 and present identical signatures (`_signature`)."""
    findings: List[Finding] = []
    if entries != 1:
        findings.append(Finding(
            rule="shape-cache-retrace", path="-", line=0, context=context,
            message=f"{len(variants)} scenarios of one shape took {entries} shape-cache "
                    "entries"))
    if not variants:
        return findings
    ref = _signature(variants[0])
    for i, v in enumerate(variants[1:], start=1):
        sig = _signature(v)
        if sig != ref:
            diff = [f"{a} != {b}" for a, b in zip(ref, sig) if a != b] or [
                f"arity {len(ref)} != {len(sig)}"]
            findings.append(Finding(
                rule="shape-cache-retrace", path="-", line=0, context=context,
                message=f"variant {i} changes the simulator's signature "
                        f"({'; '.join(str(d) for d in diff[:3])})"))
    return findings


# ---------------------------------------------------------------------------
# the registered-combination grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Combo:
    model: str
    summary: Optional[str]
    distance: str
    sched_shape: int  # number of intervention windows (0 = no schedule)
    #: regionalize the model to this R at audit time (1 = as registered;
    #: metapop_seir is 4-region as registered)
    regions: int = 1
    #: the device loop: "single" (`core.abc.WaveRunner`) or "pjit"
    #: (`core.distributed.PjitWaveRunner`, a world of 1)
    style: str = "single"

    @property
    def tag(self) -> str:
        return (f"{self.model}/{self.summary or 'identity'}/{self.distance}/"
                f"sched{self.sched_shape}" + (f"/r{self.regions}" if self.regions > 1 else "")
                + ("/pjit" if self.style == "pjit" else ""))


def registered_combos(quick: bool = False) -> List[Combo]:
    """The full registered grid; `quick` covers every axis value while
    holding the others at defaults (axis coverage, not the cross product)."""
    from repro_torch.core.summaries import DISTANCE_KINDS, list_summaries
    from repro_torch.epi.models import list_models

    models = list(list_models())
    summaries = [None] + [s for s in list_summaries() if s != "identity"]
    distances = list(DISTANCE_KINDS)
    sched_shapes = [0, 2]
    # the pjit device loop, flat and on the region axis
    pjit = [Combo("siard" if "siard" in models else models[0], None, distances[0], 0,
                  style="pjit")]
    if "metapop_seir" in models:
        pjit.append(Combo("metapop_seir", None, distances[0], 0, regions=3, style="pjit"))
    if not quick:
        full = [Combo(m, su, d, ss) for m, su, d, ss in itertools.product(
            models, summaries, distances, sched_shapes)]
        # the region axis: a coupled metapop and an uncoupled base model
        # regionalized at audit time, both pooling modes
        full += [Combo(m, su, distances[0], ss, regions=3)
                 for m in ("metapop_seir", "seir") if m in models
                 for su in (None, "region_pooled") for ss in sched_shapes]
        return full + pjit
    base = Combo(models[0], None, distances[0], 0)
    combos = {base, *pjit}
    for m in models:
        combos.add(dataclasses.replace(base, model=m))
    for su in summaries:
        combos.add(dataclasses.replace(base, summary=su))
    for d in distances:
        combos.add(dataclasses.replace(base, distance=d))
    for ss in sched_shapes:
        combos.add(dataclasses.replace(base, sched_shape=ss))
    if "metapop_seir" in models:
        combos.add(dataclasses.replace(base, model="metapop_seir", regions=3,
                                       summary="region_pooled"))
    if "seir" in models:
        combos.add(dataclasses.replace(base, model="seir", regions=3))
    return sorted(combos, key=lambda c: c.tag)


def _resolve_spec(combo: Combo):
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize

    spec = get_model(combo.model)
    if combo.regions > 1:
        spec = regionalize(spec, combo.regions, "ring:0.1")
    return spec


def _schedule_for(shape: int, days: Sequence[int], spec):
    if shape == 0:
        return None
    from repro_torch.epi.spec import InterventionSchedule

    return InterventionSchedule.inferred((spec.param_names[0],), tuple(days[:shape]))


def _segment(runner, seed: int, run_idx0: int, carry, waves: int):
    """One segment, enqueue and read, under a recorder: (output, events,
    reads of sync_counts)."""
    from repro_torch.core import abc

    reads0 = abc.HOST_SYNCS
    rec = DispatchRecorder()
    with rec:
        out = runner(seed, run_idx0, carry, waves)
        runner.read(out)
    return out, rec.events, abc.HOST_SYNCS - reads0


def _sim_signature(sim, batch: int) -> Dict:
    """What a simulator presents to the loop: its tensors' shapes and dtypes,
    its width, pooling, schedule shape and the entry it would launch."""
    sched = None if sim.schedule is None else sim.schedule.shape(sim.model)
    return {"tensors": {k: v for k, v in vars(sim).items() if isinstance(v, torch.Tensor)},
            "width": sim.width, "pool": sim.pool, "entry": sim.entry("wave", batch),
            "schedule": None if sched is None else (sched.n_windows, sched.tv_indices)}


def _shape_cache_variants(combo: Combo, spec, num_days: int, batch: int):
    """Two (or, under a schedule, three) scenarios the campaign's shape cache
    maps to one key: another dataset, and other breakpoint days of the same
    window count. Returns (signatures, entries taken, keys)."""
    from repro_torch.core.campaign import CampaignConfig, Scenario, _ShapeCache
    from repro_torch.epi.data import get_dataset, synthetic_dataset

    cfg = CampaignConfig(datasets=("synthetic_small",), models=(spec,), batch_size=batch,
                         num_days=num_days, target_accepted=8, tolerance=1.0,
                         distance=combo.distance)
    cache = _ShapeCache(cfg)
    ds_a = get_dataset("synthetic_small", num_days, spec)
    ds_b = synthetic_dataset(theta=spec.default_theta, population=5e6, num_days=num_days,
                             a0=50.0, seed=11, name="audit_variant", model=spec)
    sched = _schedule_for(combo.sched_shape, (7, 14), spec)
    cells = [(Scenario("synthetic_small", spec, schedule=sched, summary=combo.summary,
                       distance=combo.distance), ds_a),
             (Scenario("audit_variant", spec, schedule=sched, summary=combo.summary,
                       distance=combo.distance), ds_b)]
    if combo.sched_shape:
        late = _schedule_for(combo.sched_shape, (9, 19), spec)
        cells.append((Scenario("synthetic_small", spec, schedule=late, summary=combo.summary,
                               distance=combo.distance), ds_a))
    sims = [cache.simulator(sc, ds, torch.device("cpu")) for sc, ds in cells]
    return [_sim_signature(s, batch) for s in sims], cache.n_compiled


def audit_combo(combo: Combo, batch: int = 256, num_days: int = 21) -> List[Finding]:
    """Run one combo's wave loop on the CPU and every check of this pass."""
    import contextlib

    from repro_torch.core import distributed
    from repro_torch.core.abc import ABCConfig, ABCState, make_simulator, make_wave_runner
    from repro_torch.core.priors import schedule_prior
    from repro_torch.epi.data import get_dataset

    try:
        spec = _resolve_spec(combo)
        # a tolerance every finite distance meets and a small target: the
        # first wave fills the target, the waves after it run gated
        cfg = ABCConfig(batch_size=batch, chunk_size=batch, num_days=num_days,
                        tolerance=3e38, target_accepted=8, model=spec,
                        summary=combo.summary, distance=combo.distance,
                        schedule=_schedule_for(combo.sched_shape, (7, 14), spec),
                        wave_loop="device")
        prior = schedule_prior(spec, cfg.schedule)
        sim = make_simulator(get_dataset("synthetic_small", num_days, spec), cfg, "cpu")
        with (distributed.world("cpu") if combo.style == "pjit"
              else contextlib.nullcontext()) as group:
            runner = (distributed.make_pjit_wave_runner(group, prior, sim, cfg)
                      if combo.style == "pjit" else make_wave_runner(prior, sim, cfg))
            carry = runner.init(ABCState(n_params=prior.dim))
            out1, ev1, reads1 = _segment(runner, 0, 0, carry, 1)
            out2, ev2, reads2 = _segment(runner, 0, 1, runner.carry_of(out1), 3)
        variants, entries = _shape_cache_variants(combo, spec, num_days, batch)
    except Exception as e:  # a combo that cannot run
        return [Finding(rule="audit-trace-error", path="-", line=0, context=combo.tag,
                        message=f"{type(e).__name__}: {e}")]
    ptrs = [(o.theta_buf.data_ptr(), o.dist_buf.data_ptr()) for o in (out1, out2)]
    allocs = {1: wave_buffer_allocations(ev1, batch, prior.dim),
              3: wave_buffer_allocations(ev2, batch, prior.dim)}
    return (audit_dtypes(ev1 + ev2, combo.tag)
            + audit_syncs(ev1, reads1, 1, combo.tag) + audit_syncs(ev2, reads2, 1, combo.tag)
            + audit_buffers(ptrs, allocs, combo.tag)
            + audit_shape_cache(variants, combo.tag, entries))


def run_audit(quick: bool = False, log=None) -> List[Finding]:
    findings: List[Finding] = []
    combos = registered_combos(quick=quick)
    for i, combo in enumerate(combos):
        if log and (i % 30 == 0 or i + 1 == len(combos)):
            log(f"[trace_audit] combo {i + 1}/{len(combos)}: {combo.tag}")
        findings.extend(audit_combo(combo))
    return findings
