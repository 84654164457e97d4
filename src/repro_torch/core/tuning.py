"""Roofline-instrumented autotuning of the fused ABC hot path (port of
`repro.core.tuning`).

Three layers, as in `repro`:

  1. **Analytic cost model** (`cost_model`): operations and HBM bytes a
     sample-day for any `(CompartmentalModel, schedule, summary, distance)`.
     The operation count comes from running ONE day of the port's plain
     dynamics (`rng.hash_normals`, `engine.effective_theta`,
     `engine.tau_leap_step`, `summaries.running_day`) under a counting
     dispatch mode (`count_fn_ops`), so it is derived from the spec and
     stays right when a model is registered. The byte model is closed-form:
     the fused kernel reads `theta_width` floats and writes one distance a
     sample (36 B for the unscheduled paper model); the naive path pays
     `(n_transitions + n_observed + 2 * n_state) * 4` bytes a sample-DAY.

  2. **Roofline instrumentation** (`roofline_metrics`): a measured (samples,
     wall) cell as `achieved_flops`, `achieved_bytes_per_s`,
     `arithmetic_intensity` and `roofline_efficiency` against the ceiling
     `min(F32_OPS_PER_S, HBM_BYTES_PER_S * intensity)` of the card
     (`repro_torch.device`).

  3. **Measured autotuner and persistent cache** (`autotune`,
     `TuningCache`): a best-of-N search over the CUDA block size, which is
     pure scheduling: the kernel's sample index does not depend on it, so
     the distances, and with them the accepted set, are the same bits for
     every block (`kernels/abc_sim.py`, `core/abc.py`'s `ABCConfig.block`).
     That is what lets `resolve_tuned` apply the winner. The wave batch is
     measured too and recorded as `best_batch`, ADVISORY ONLY: another
     batch draws other samples, so it is never applied behind the caller's
     back.

     Winners persist in a JSON cache keyed by `(backend, model, days, batch,
     summary, distance, schedule shape)`, by default
     `experiments/tuning/cache_torch.json` (not committed; `repro`'s
     `cache.json` is `repro`'s). `core.abc.make_simulator` consults it when
     `ABCConfig.autotune` is set (a hit measures nothing), and so do the
     campaign's shape cache and the scaling study's cells.

Not ported: `repro`'s `scan_unroll` (its `xla_fused` backend) and `tile`
(its Pallas grid); the port's one knob of this kind is `block`.

CLI (refresh the cache on the card):

    PYTHONPATH=src python -m repro_torch.core.tuning --dataset italy \\
        --models siard --batch 100000 --days 49
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import F32_OPS_PER_S, HBM_BYTES_PER_S, card_label, resolve_device
from repro_torch.ioutils import atomic_write

_REPO = Path(__file__).resolve().parents[3]
#: where tuning winners persist (not committed)
TUNING_DIR = _REPO / "experiments" / "tuning"
DEFAULT_CACHE_PATH = TUNING_DIR / "cache_torch.json"
CACHE_SCHEMA = "tuning-cache/v1"

#: CUDA block candidates of the measured search, in threads (filtered per
#: model by the kernels' launch bounds)
BLOCK_CANDIDATES = (64, 128, 256, 384, 512)
#: wave-batch candidates, as factors of the configured batch (advisory only)
BATCH_FACTORS = (0.5, 1.0, 2.0)


# --------------------------------------------------------------------------
# 1. Analytic cost model, derived from the model spec
# --------------------------------------------------------------------------

#: aten operations counted as one operation an output element: the
#: counterparts of `repro`'s `_OP_PRIMS` (elementwise arithmetic, math,
#: comparisons, bitwise and shift operations, selects and clamps).
#: Reductions, views, copies, casts and factories are not counted, as
#: `repro` counts no reduce, reshape, convert or iota.
_OP_ATEN = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg", "sign", "sgn", "abs",
    "maximum", "minimum", "pow", "sqrt", "rsqrt", "reciprocal", "square",
    "log", "log1p", "exp", "expm1", "tanh", "sigmoid", "erf", "erfinv",
    "floor", "ceil", "round", "trunc", "nextafter",
    "sin", "cos", "atan2", "isnan",
    "eq", "ne", "lt", "le", "gt", "ge",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "__and__", "__or__", "__xor__",
    "__lshift__", "__rshift__", "__ilshift__", "__irshift__",
    "bitwise_left_shift", "bitwise_right_shift",
    "where", "clamp", "clamp_min", "clamp_max",
})
_AND_OPS = frozenset({"bitwise_and", "__and__"})


def _aten_name(func) -> str:
    """`aten.add_.Tensor` -> "add": the packet's name less an in-place `_`."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _is_mask32(x) -> bool:
    from repro_torch.kernels.rng import MASK32

    if isinstance(x, torch.Tensor):
        return x.ndim == 0 and not x.is_floating_point() and int(x) == MASK32
    return isinstance(x, int) and x == MASK32


class _OpCounter(TorchDispatchMode):
    """Counts `_OP_ATEN` operations, one an output element. A
    `& MASK32` on an integer tensor only emulates uint32 wraparound in the
    hash twin's int64 words and is free; inside `word_op()` the operations
    count as one a result element (an emulated uint32 multiply)."""

    def __init__(self):
        super().__init__()
        self.total = 0.0
        self._inside = 0

    @contextlib.contextmanager
    def word_op(self):
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._inside:
            return out
        name = _aten_name(func)
        if name not in _OP_ATEN:
            return out
        if (name in _AND_OPS and len(args) == 2 and isinstance(args[0], torch.Tensor)
                and not args[0].is_floating_point() and _is_mask32(args[1])):
            return out  # wraparound of an emulated uint32 word
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.total += float(max((o.numel() for o in outs if isinstance(o, torch.Tensor)),
                                default=1))
        return out


def count_fn_ops(fn, *args) -> float:
    """Arithmetic operations of `fn(*args)`, one an output element.

    The port's counterpart of `repro`'s `count_jaxpr_ops` of a jaxpr: here
    `fn` runs eagerly under a dispatch mode that sees every aten operation.
    The two currencies differ where the port emulates what the TPU does
    natively: PyTorch has no dependable uint32 multiply, so the counter hash
    (`kernels/rng.py`) keeps its words in int64 tensors. Counted as such,
    its `_mul32` is 7 operations for one multiply and each `& MASK32` adds
    one, and a SIARD day counts 584 operations a sample against `repro`'s
    342. Here they count as the uint32 operations they stand for: a
    `_mul32` is one multiply (one an output element) and a `& MASK32` is
    free. What remains differs from `repro` only in how each side spells
    the same arithmetic (a `where` for a `select_n`, a clamp for a max and
    a min), within the 15% `repro` allows its own cross-check.
    """
    from unittest import mock

    from repro_torch.kernels import rng

    counter = _OpCounter()
    plain_mul32 = rng._mul32

    def mul32(x, m):
        if not isinstance(x, torch.Tensor):
            return plain_mul32(x, m)
        with counter.word_op():
            out = plain_mul32(x, m)
        counter.total += float(out.numel())
        return out

    with mock.patch.object(rng, "_mul32", mul32), counter:
        fn(*args)
    return counter.total


@functools.lru_cache(maxsize=None)
def _flops_per_sample_day(model, schedule, summary, distance: str) -> float:
    """Run ONE day of the plain dynamics and count operations a sample.

    All arguments are hashable statics (the spec is frozen); the day index,
    seed, breakpoints and observed values are tensors, so every operation
    that touches them is counted as it is on a traced day.
    """
    from repro_torch.core.summaries import (
        get_distance_kind,
        get_summary,
        pool_channels,
        pool_factor,
        running_day,
    )
    from repro_torch.epi import engine
    from repro_torch.epi.spec import active_schedule
    from repro_torch.kernels import rng

    spec = get_summary(summary)
    kind = get_distance_kind(distance)
    schedule = active_schedule(schedule)
    b = 256  # large enough to amortize the few scalar operations a day
    pool = pool_factor(spec, model.n_regions)
    n_obs = model.total_observed // pool  # summary channels after pooling
    obs_idx = torch.tensor(model.total_observed_idx, dtype=torch.int64)
    width = model.n_params if schedule is None else schedule.param_width(model)
    n_windows = 0 if schedule is None else schedule.n_windows

    def day(theta, state, cum, binv, acc, day_idx, obs_t, flush_t, seed, idx, bps):
        z = rng.hash_normals(seed, idx, day_idx, model.total_transitions, model.ctr_slots)
        th_d = engine.effective_theta(model, schedule, theta, day_idx,
                                      breakpoints=bps if n_windows else None)
        nxt = engine.tau_leap_step(model, state, th_d, z, 1e6)
        return running_day(spec, kind, torch.ones((n_obs,)),
                           pool_channels(nxt[:, obs_idx], pool), obs_t, flush_t, cum,
                           binv, acc)

    args = (
        torch.zeros((b, width)),  # theta
        torch.zeros((b, model.total_state)),  # state (all regions)
        torch.zeros((b, n_obs)),  # cum carry
        torch.zeros((b, n_obs)),  # bin carry
        torch.zeros((b,)),  # distance accumulator
        torch.zeros((), dtype=torch.int64),  # day index
        torch.zeros((n_obs,)),  # observed summary at the day
        torch.ones(()),  # flush flag
        torch.zeros((), dtype=torch.int64),  # RNG seed
        torch.arange(b),  # global sample indices
        torch.ones((max(n_windows, 1),), dtype=torch.int64),  # breakpoint days
    )
    return count_fn_ops(day, *args) / b


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Analytic per-sample cost of the fused ABC hot path for one spec."""

    model: str
    days: int
    theta_width: int  # params + schedule scale columns
    #: region-major flattened totals (the per-region counts at R=1)
    n_transitions: int
    n_state: int
    n_observed: int
    #: counted operations of one simulated day a sample (spec-derived)
    flops_per_sample_day: float
    #: fused-path HBM bytes a sample: theta row in + one distance out
    fused_bytes_per_sample: float
    #: naive-path bytes a sample-DAY: noise + trajectory + state round trip
    naive_bytes_per_sample_day: float
    n_regions: int = 1

    def flops(self, n_samples: float, days: Optional[int] = None) -> float:
        return n_samples * (days or self.days) * self.flops_per_sample_day

    def fused_bytes(self, n_samples: float) -> float:
        return n_samples * self.fused_bytes_per_sample

    def naive_bytes(self, n_samples: float, days: Optional[int] = None) -> float:
        return n_samples * (days or self.days) * self.naive_bytes_per_sample_day

    @property
    def arithmetic_intensity_fused(self) -> float:
        return self.days * self.flops_per_sample_day / self.fused_bytes_per_sample

    @property
    def arithmetic_intensity_naive(self) -> float:
        return self.flops_per_sample_day / self.naive_bytes_per_sample_day


def cost_model(model, days: int, schedule=None, summary=None,
               distance: str = "euclidean") -> CostModel:
    """The analytic cost model of any registered (or ad-hoc) spec.

    `model` is a registry name or a `CompartmentalModel`; `schedule` widens
    theta (more fused bytes) and adds the day's window selects; `summary`
    and `distance` change the day's accumulator operations.
    """
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import active_schedule

    spec = get_model(model)
    schedule = active_schedule(schedule)
    width = spec.n_params if schedule is None else schedule.param_width(spec)
    return CostModel(
        model=spec.name,
        days=int(days),
        theta_width=width,
        n_transitions=spec.total_transitions,
        n_state=spec.total_state,
        n_observed=spec.total_observed,
        n_regions=spec.n_regions,
        flops_per_sample_day=_flops_per_sample_day(spec, schedule, summary, distance),
        fused_bytes_per_sample=(width + 1) * 4.0,
        naive_bytes_per_sample_day=(
            (spec.total_transitions + spec.total_observed + 2 * spec.total_state) * 4.0
        ),
    )


# --------------------------------------------------------------------------
# 2. Roofline instrumentation of measured cells
# --------------------------------------------------------------------------

def roofline_from_totals(flops: float, hbm_bytes: float, wall_s: float) -> Dict:
    """achieved/intensity/efficiency fields from raw totals.

    `roofline_efficiency` is the measured rate over the ceiling
    `min(F32_OPS_PER_S, HBM_BYTES_PER_S * intensity)`. The ceiling takes the
    card's float32 rate outside the tensor cores, not `repro`'s bf16 peak
    (a TPU v5e's MXU rate): the simulation is float32 arithmetic on the
    CUDA cores, which the tensor cores cannot do. On the CPU the value is
    tiny (the ceiling models the card); only its drift means anything there.
    """
    wall_s = max(float(wall_s), 1e-12)
    ai = flops / max(hbm_bytes, 1.0)
    achieved = flops / wall_s
    ceiling = min(F32_OPS_PER_S, HBM_BYTES_PER_S * ai)
    return {
        "achieved_flops": achieved,
        "achieved_bytes_per_s": hbm_bytes / wall_s,
        "arithmetic_intensity": ai,
        "roofline_efficiency": achieved / max(ceiling, 1e-12),
    }


def roofline_metrics(cm: CostModel, n_samples: float, wall_s: float,
                     days: Optional[int] = None) -> Dict:
    """One measured cell (simulations, wall clock) as roofline fields, on the
    FUSED byte model: the hot path the kernel implements."""
    return roofline_from_totals(cm.flops(n_samples, days), cm.fused_bytes(n_samples), wall_s)


# --------------------------------------------------------------------------
# 3. Persistent tuning cache
# --------------------------------------------------------------------------

def _schedule_shape_tag(model, schedule) -> str:
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import active_schedule

    schedule = active_schedule(schedule)
    if schedule is None:
        return "nosched"
    shape = schedule.shape(get_model(model))
    return f"w{shape.n_windows}tv{len(shape.tv_indices)}"


def _model_name(model) -> str:
    from repro_torch.epi.models import get_model

    return model if isinstance(model, str) else get_model(model).name


def cache_key(*, backend: str, model, days: int, batch: int, summary: str = "identity",
              distance: str = "euclidean", schedule=None) -> str:
    """The tuning-cache key: everything that changes the tuned optimum."""
    sched = _schedule_shape_tag(model, schedule)
    return f"{backend}/{_model_name(model)}/d{days}/b{batch}/{summary}/{distance}/{sched}"


def cfg_cache_key(cfg) -> str:
    """Cache key of an `ABCConfig` (its summary resolved to a stable tag)."""
    return cache_key(backend=cfg.backend, model=cfg.model, days=cfg.num_days,
                     batch=cfg.batch_size, summary=cfg.summary_spec.tag(),
                     distance=cfg.distance, schedule=cfg.schedule)


class TuningCache:
    """JSON-backed map of cache_key -> winning knob entry.

    Reads are lazy; writes are atomic (`ioutils.atomic_write`). A corrupt or
    schema-mismatched file raises ValueError LOUDLY instead of silently
    retuning from scratch.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else DEFAULT_CACHE_PATH
        self._entries: Optional[Dict[str, Dict]] = None

    def _load(self) -> None:
        if self._entries is not None:
            return
        if not self.path.exists():
            self._entries = {}
            return
        try:
            payload = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"corrupt tuning cache {self.path} ({e}); delete it and re-run "
                "autotuning (python -m repro_torch.core.tuning)"
            ) from e
        if (not isinstance(payload, dict) or payload.get("schema") != CACHE_SCHEMA
                or not isinstance(payload.get("entries"), dict)):
            raise ValueError(
                f"tuning cache {self.path} is not a {CACHE_SCHEMA} payload; delete it "
                "and re-run autotuning (python -m repro_torch.core.tuning)"
            )
        self._entries = payload["entries"]

    def get(self, key: str) -> Optional[Dict]:
        self._load()
        return self._entries.get(key)

    def entries(self) -> Dict[str, Dict]:
        self._load()
        return dict(self._entries)

    def put(self, key: str, entry: Dict) -> None:
        self._load()
        self._entries[key] = entry
        payload = {"schema": CACHE_SCHEMA, "entries": self._entries}
        with atomic_write(self.path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)


# --------------------------------------------------------------------------
# 4. Measured best-of-N search
# --------------------------------------------------------------------------

def measure_simulator(dataset, cfg, *, reps: int = 2, warmup: int = 1, seed: int = 0,
                      batch: Optional[int] = None, device="cuda") -> float:
    """Best-of-`reps` wall seconds of one simulator wave under `cfg`.

    Builds the simulator with autotuning OFF (so the search never recurses
    into itself) and times `sim.wave(prior, seed, seed + 1, b)` to
    `torch.cuda.synchronize`, warm-up excluded: on the card one launch of
    the kernel's wave entry, which the main path runs, drawing theta from
    `schedule_prior(...)` as `prior.sample(seed, b, device)` draws it (the
    CPU's wave is that call and the plain version).
    """
    from repro_torch.core.abc import make_simulator
    from repro_torch.core.priors import schedule_prior
    from repro_torch.epi.models import get_model

    dev = resolve_device(device)
    b = int(batch or cfg.batch_size)
    cfg = dataclasses.replace(cfg, autotune=False)
    if batch is not None:
        # batch candidates only probe throughput; the block takes its default
        cfg = dataclasses.replace(cfg, batch_size=b, chunk_size=b, block=None)
    sim = make_simulator(dataset, cfg, dev)
    prior = schedule_prior(get_model(cfg.model), cfg.schedule)

    def wave():
        sim.wave(prior, seed, seed + 1, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(0, warmup)):
        wave()
    best = None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        wave()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def block_candidates(model, batch: int) -> Tuple[int, ...]:
    """Search space of the CUDA block: `BLOCK_CANDIDATES` within the launch
    bound of every kernel the model may run (`abc_sim.check_kernel_block`:
    `MAX_BLOCK` for the flat kernel and the thread route, `WARP_MAX_BLOCK`
    for the warp route), plus the default of the kernel that runs at
    `batch` where a config may name it."""
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim

    spec = get_model(model)
    route = abc_sim.regional_route(spec, batch) if spec.is_regional else "thread"
    cands = set()
    for block in (*BLOCK_CANDIDATES, abc_sim.route_block(route)):
        try:
            abc_sim.check_kernel_block(spec, block)
        except ValueError:
            continue
        cands.add(int(block))
    return tuple(sorted(cands))


def autotune(dataset, cfg, *, cache: Optional[TuningCache] = None, reps: int = 2,
             measure: Optional[Callable] = None, measure_batches: bool = True,
             verbose: bool = False, device="cuda") -> Dict:
    """Measured best-of-N search for `cfg`'s backend; returns the cache entry.

    A cache HIT returns at once and measures nothing. On a miss it measures
    each block of `block_candidates` (the winner is applied by
    `resolve_tuned`: distances do not depend on the block) and, optionally,
    the wave-batch candidates, whose winner `best_batch` is ADVISORY ONLY
    (another batch draws other samples). The entry records the card
    (`device.card_label`). `measure(cfg, batch=None) -> seconds` can be
    injected for tests.
    """
    if cfg.backend != "cuda":
        raise ValueError(f"autotune tunes the cuda backend's block; backend "
                         f"{cfg.backend!r} has none")
    cache = cache if cache is not None else TuningCache()
    key = cfg_cache_key(cfg)
    hit = cache.get(key)
    if hit is not None:
        return hit
    if measure is None:
        def measure(c, batch=None):
            return measure_simulator(dataset, c, reps=reps, batch=batch, device=device)

    entry: Dict = {
        "schema": CACHE_SCHEMA,
        "backend": cfg.backend,
        "model": _model_name(cfg.model),
        "days": cfg.num_days,
        "batch": cfg.batch_size,
        "summary": cfg.summary_spec.tag(),
        "distance": cfg.distance,
        "schedule": _schedule_shape_tag(cfg.model, cfg.schedule),
    }
    measurements: Dict[str, float] = {}
    for block in block_candidates(cfg.model, cfg.batch_size):
        dt = measure(dataclasses.replace(cfg, block=block))
        measurements[f"block{block}"] = dt
        if verbose:
            print(f"[tuning] {key}: block={block} -> {dt * 1e3:.3f} ms")
    best = min(measurements, key=measurements.get)
    entry["block"] = int(best[len("block"):])

    if measure_batches:
        best_batch, best_tp = None, -1.0
        for f in BATCH_FACTORS:
            b = int(cfg.batch_size * f)
            if b < 256:
                continue
            dt = measure(cfg, batch=b)
            measurements[f"batch{b}"] = dt
            if b / dt > best_tp:
                best_batch, best_tp = b, b / dt
            if verbose:
                print(f"[tuning] {key}: batch={b} -> {b / dt:,.0f} sims/s")
        # advisory: applying it would change the waves' samples
        entry["best_batch"] = best_batch

    entry["measurements"] = measurements
    entry["device"] = card_label(device)
    cache.put(key, entry)
    return entry


def resolve_tuned(dataset, cfg, cache: Optional[TuningCache] = None, device="cuda"):
    """An `ABCConfig` with the tuned block filled in from the cache.

    A no-op unless `cfg.autotune` is set. An explicit `block` wins over the
    cached winner; `best_batch` is never applied (advisory only). The
    returned config has `autotune=False`, so that nothing downstream,
    including the search's own probes, enters the tuner again.
    """
    if not getattr(cfg, "autotune", False):
        return cfg
    entry = autotune(dataset, cfg, cache=cache, device=device)
    repl: Dict = {"autotune": False}
    if cfg.block is None and entry.get("block"):
        repl["block"] = int(entry["block"])
    return dataclasses.replace(cfg, **repl)


# --------------------------------------------------------------------------
# CLI: build or refresh the tuning cache
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    from repro_torch.core.abc import ABCConfig
    from repro_torch.epi.data import get_dataset

    ap = argparse.ArgumentParser(
        description="Measure and persist the port's ABC hot-path tuning winners."
    )
    ap.add_argument("--dataset", default="synthetic_small")
    ap.add_argument("--models", nargs="+", default=["siard", "sir"])
    ap.add_argument("--backends", nargs="+", default=["cuda"], choices=["cuda"])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--days", type=int, default=20)
    ap.add_argument("--summary", default="identity")
    ap.add_argument("--distance", default="euclidean")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache", default=str(DEFAULT_CACHE_PATH))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-batch-search", action="store_true",
                    help="skip the (advisory) wave-batch measurements")
    args = ap.parse_args(argv)

    cache = TuningCache(args.cache)
    for model in args.models:
        ds = get_dataset(args.dataset, num_days=args.days, model=model)
        for backend in args.backends:
            cfg = ABCConfig(
                batch_size=args.batch, chunk_size=args.batch, num_days=args.days,
                backend=backend, model=model,
                summary=None if args.summary == "identity" else args.summary,
                distance=args.distance, autotune=True,
            )
            entry = autotune(ds, cfg, cache=cache, reps=args.reps,
                             measure_batches=not args.no_batch_search, verbose=True,
                             device=args.device)
            knobs = {k: entry.get(k) for k in ("block", "best_batch")
                     if entry.get(k) is not None}
            print(f"[tuning] {cfg_cache_key(cfg)} -> {knobs} ({entry.get('device')})")
            cm = cost_model(model, args.days, summary=cfg.summary, distance=args.distance)
            print(f"[tuning]   cost model: {cm.flops_per_sample_day:.0f} ops/sample-day, "
                  f"{cm.fused_bytes_per_sample:.0f} B/sample fused "
                  f"(AI {cm.arithmetic_intensity_fused:.0f}), "
                  f"{cm.naive_bytes_per_sample_day:.0f} B/sample-day naive")
    print(f"[tuning] cache: {cache.path} ({len(cache.entries())} entries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
