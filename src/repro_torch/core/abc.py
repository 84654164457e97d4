"""Parallel ABC rejection sampling (paper §3): the host and the device wave
loops (port).

Counterpart of `repro.core.abc` for the "pallas" backend, whose port is the
"cuda" backend here, and for the amortized "npe" backend, which `run_abc`
hands to `core.npe.run_npe` (no waves). Each wave:

    theta  ~ prior                      [B, p]   counter-hash draws
    dist   = fused kernel(theta)        [B]      simulate + summary distance
    accept = dist <= tolerance
    return samples to the host under a fixed-shape strategy:
      - "outfeed": split the batch into chunks; only chunks holding an
        accepted sample are copied to the host;
      - "topk": the k lowest-distance samples per wave; the host filters.

On a CUDA device the first two lines are one launch of the kernel's wave
entry, which draws theta inside the kernel (`ops.AbcSim.wave`); on the CPU
they are `prior.sample` and the plain version, to the same bits.

A regional model (a spec from `epi.spec.regionalize`, or the registered
metapop_seir) runs the same loop through the kernel's region axis;
`ABCConfig.mobility` overrides its coupling matrix, checked here and sent
to the device once a simulator.

Under an intervention schedule (`ABCConfig.schedule`) the prior is the box
widened by the schedule's scale bounds (`priors.schedule_prior`) and the
posterior's columns are the model's parameters followed by the scales
(`alpha0_w1`, ...); an empty schedule is exactly None.

Wave i draws its prior seed and its simulation seed from (seed, i) as two
distinct streams of the port's hash (`wave_seeds`), so any wave can be
recomputed from the base seed and its index, and a run resumed from an
`ABCState` gives the same accepted set as one left uninterrupted.

Two loops run the waves (`ABCConfig.wave_loop`):

  * host loop: the host harvests each wave before it starts the next, one
    copy of the chunk flags and one of each flagged chunk (`_harvest`);
  * device loop (`WaveRunner`): the host enqueues a segment of up to
    `SEGMENT_WAVES` waves without waiting. Each wave runs under a device
    gate, `accepted < target`, which the kernel reads when it runs, and
    compacts its accepted rows into a fixed accept buffer on the device
    (`compact_accepted`); a wave enqueued past the target writes nothing.
    After the segment the host reads the counts once and copies the
    accepted rows. With the same seed it gives the host loop's accepted
    set: the same rows in the same order, the same runs and simulations.
    "auto" picks it for outfeed runs, as `repro` does. On a CUDA device
    with one shard, a runner that has run one full segment eagerly
    captures the next full segment as a CUDA graph on buffers of its own,
    and from then on replays it once a full segment (the graph path,
    `WaveRunner`), with the waves' seeds written to device memory before
    each replay: the same accepted set, without the host's enqueue of
    every launch.

Sharded runs (`core.distributed`, one rank a shard, and the lockstep
reference of `core.scaling`, every shard in one process) keep `repro`'s
buffer layout: one segment of `wave_capacity(cfg, B / shards)` rows a shard
(plus its spare row), `fill_counts` of shape [shards], a resumed state split
over the segments by `np.array_split` (`split_state`), so a state written by
either package resumes on any shard count. Shard s of wave i draws with
`shard_seeds(seed, i, s)`: shard 0 keeps `wave_seeds(seed, i)`, so one shard
is the unsharded run bit for bit, and shard s >= 1 hashes both of them with
(s, SHARD_STREAM). `repro` instead folds the device index into each shard's
threefry key; the two are held to each other by statistics, not bitwise.
"""

from __future__ import annotations

import dataclasses
import time
import zipfile
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.posterior import Posterior
from repro_torch.core.priors import UniformBoxPrior, schedule_prior
from repro_torch.core.summaries import SummarySpec, get_distance_kind, get_summary
from repro_torch.device import resolve_device
from repro_torch.epi.data import CountryData
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import active_schedule, validate_mobility
from repro_torch.ioutils import atomic_write
from repro_torch.kernels import abc_sim, compact, ops
from repro_torch.kernels.rng import MASK32, _hash, stream_seed
from repro_torch.runtime.trace import span

#: hash streams of (seed, index): the waves' prior and simulation seeds,
#: and the pilot waves' of `calibrate_tolerance`; SHARD_STREAM derives shard
#: s >= 1's seeds of a wave from the wave's own (`shard_seeds`)
PRIOR_STREAM, SIM_STREAM, PILOT_PRIOR_STREAM, PILOT_SIM_STREAM, SHARD_STREAM = range(5)

#: waves the device loops enqueue between two reads of their counts: the
#: main path's 9 waves fit in one segment, and a run that stops early pays
#: for at most 15 gated launches, which write nothing
SEGMENT_WAVES = 16
#: host syncs of the device loops (ABC and SMC rounds): one a segment
HOST_SYNCS = 0
#: segments that `WaveRunner`'s graph path captured as a CUDA graph (one a
#: runner) and replayed; GRAPH_REPLAYS over HOST_SYNCS is the share of the
#: segments that took it
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
#: compactions that took the kernel (`compact_accepted` on CUDA tensors)
COMPACT_KERNEL_LAUNCHES = 0
#: auto mode only picks the device loop when the accept buffer stays small
#: enough to live comfortably on one device (rows, not bytes)
_AUTO_DEVICE_MAX_ROWS = 4_000_000


@dataclasses.dataclass(frozen=True)
class ABCConfig:
    """Configuration of a parallel ABC inference run."""

    batch_size: int = 100_000  # simulations per wave
    tolerance: float = 2e5
    target_accepted: int = 100
    strategy: str = "outfeed"  # "outfeed" | "topk"
    chunk_size: int = 10_000  # outfeed chunk granularity (paper default)
    top_k: int = 5  # samples returned per wave under "topk"
    max_runs: int = 100_000
    distance: str = "euclidean"
    #: "cuda": the fused CUDA kernel on a CUDA device, its plain PyTorch
    #: version on the CPU; "npe": an amortized estimator (`core.npe`), no
    #: waves
    backend: str = "cuda"
    num_days: int = 49
    #: the model to infer: a registry name (repro_torch.epi.models) or a
    #: spec, such as a regionalized one (`epi.spec.regionalize`)
    model: object = "siard"
    #: summary statistic compared by `distance`: a name, a SummarySpec or
    #: None for the paper's raw daily series
    summary: Optional[object] = None
    #: CUDA block size in threads, None for the kernel's own default
    #: (`abc_sim.check_kernel_block`); distances do not depend on it
    block: Optional[int] = None
    #: intervention schedule (`epi.spec.InterventionSchedule`); None or an
    #: empty one: the model's own parameters only
    schedule: Optional[object] = None
    #: regional models only: a row-stochastic [R][R] mobility matrix (nested
    #: tuples) in place of the spec's, checked here (rows must sum to 1); its
    #: region count is checked against the model's when a simulator is made
    #: (`resolved_mobility`). None keeps the model's own matrix.
    mobility: Optional[Tuple[Tuple[float, ...], ...]] = None
    #: the wave loop: "host" (the host harvests every wave), "device"
    #: (segments of gated waves with a device accept buffer, one host sync a
    #: segment) or "auto" (device for "outfeed" when the buffer fits, else
    #: host); both give the same accepted set for the same seed
    wave_loop: str = "auto"
    #: backend="npe" only: training hyperparameters (`core.npe.NPEConfig`);
    #: None uses the NPEConfig defaults
    npe: Optional[object] = None
    #: fill `block` from the measured tuning cache when the simulator is
    #: made (`core.tuning.resolve_tuned`; a miss runs the search once and
    #: persists it). An explicit `block` wins; the distances are the same
    autotune: bool = False

    def __post_init__(self):
        if self.strategy not in ("outfeed", "topk"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.strategy == "outfeed" and self.batch_size % self.chunk_size:
            raise ValueError("batch_size must be a multiple of chunk_size")
        if self.strategy == "topk" and not 0 < self.top_k <= self.batch_size:
            raise ValueError(f"top_k must be in [1, batch_size], got {self.top_k}")
        if self.backend not in ("cuda", "npe"):
            raise ValueError(
                f"unknown backend {self.backend!r}; the port has the 'cuda' and "
                "'npe' backends"
            )
        if self.npe is not None:
            from repro_torch.core.npe import resolve_npe_config

            resolve_npe_config(self.npe)  # raises on a wrong type
            if self.backend != "npe":
                raise ValueError(
                    f"cfg.npe is set but backend={self.backend!r}; NPE "
                    "hyperparameters only apply to backend='npe'"
                )
        if self.autotune and self.backend != "cuda":
            raise ValueError(f"autotune tunes the cuda backend's block; backend "
                             f"{self.backend!r} has none")
        get_distance_kind(self.distance)
        get_summary(self.summary)
        spec = get_model(self.model)
        abc_sim.check_kernel_block(spec, self.block)
        schedule = active_schedule(self.schedule)
        if schedule is not None:
            schedule.shape(spec)  # its parameters are the model's
        if self.mobility is not None:
            # nested float tuples keep the frozen config hashable
            object.__setattr__(self, "mobility",
                               validate_mobility(self.mobility, len(self.mobility)))
        if self.wave_loop not in ("auto", "host", "device"):
            raise ValueError(f"unknown wave_loop {self.wave_loop!r}")
        if self.wave_loop == "device" and self.strategy == "topk":
            # the device loop compacts every sub-tolerance sample (outfeed
            # harvest semantics); it has no per-wave k cap
            raise ValueError(
                "wave_loop='device' implements outfeed harvest semantics; "
                "use strategy='outfeed' (or wave_loop='host' to keep the "
                "top-k truncation caveat)"
            )

    @property
    def num_chunks(self) -> int:
        return self.batch_size // self.chunk_size

    @property
    def summary_spec(self) -> SummarySpec:
        return get_summary(self.summary)


def resolved_mobility(cfg: ABCConfig, spec) -> Optional[Tuple[Tuple[float, ...], ...]]:
    """cfg.mobility, checked against the spec's region count; None leaves
    the spec's own matrix."""
    if cfg.mobility is None:
        return None
    if not spec.is_regional:
        raise ValueError(f"cfg.mobility set but model {spec.name!r} has no region axis")
    if len(cfg.mobility) != spec.n_regions:
        raise ValueError(
            f"cfg.mobility is {len(cfg.mobility)}x{len(cfg.mobility)} but "
            f"model {spec.name!r} has {spec.n_regions} regions"
        )
    return cfg.mobility


def run_param_names(cfg: ABCConfig, spec) -> Tuple[str, ...]:
    """Posterior column names: the model's params plus any window scales."""
    schedule = active_schedule(cfg.schedule)
    return spec.param_names if schedule is None else schedule.param_names(spec)


class RunOutput(NamedTuple):
    """Fixed-shape per-wave device outputs."""

    theta: torch.Tensor  # outfeed: [n_chunks, chunk, p]; topk: [k, p]
    dist: torch.Tensor  # outfeed: [n_chunks, chunk];    topk: [k]
    chunk_flags: torch.Tensor  # outfeed: [n_chunks] bool;  topk: [0]
    #: the sharded host-loop runner's global accepted count ([1] int64,
    #: summed over the shards); None from `abc_run_batch`
    accept_count: Optional[torch.Tensor] = None


#: (theta, seed) -> dist, and .wave(prior, prior_seed, sim_seed, batch)
SimulatorFn = ops.AbcSim


def wave_seeds(seed: int, index: int) -> Tuple[int, int]:
    """(prior seed, simulation seed) of wave `index` under base `seed`."""
    return (stream_seed(seed, index, PRIOR_STREAM),
            stream_seed(seed, index, SIM_STREAM))


def segment_seeds(seed: int, run_idx0: int, waves: int) -> np.ndarray:
    """[waves, 2] uint32: the (simulation seed, prior seed) of waves
    run_idx0 .. run_idx0 + waves - 1 under base `seed`: `wave_seeds`, in the
    other order, by the same hash over numpy arrays of words."""
    idx = np.arange(run_idx0, run_idx0 + waves, dtype=np.int64)[:, None] & MASK32
    return _hash(int(seed) & MASK32, idx, np.array([SIM_STREAM, PRIOR_STREAM])).astype(np.uint32)


def split_seeds(prior_seed: int, sim_seed: int, shard: int) -> Tuple[int, int]:
    """Shard `shard`'s (prior seed, simulation seed) of a wave whose own are
    (prior_seed, sim_seed): shard 0 keeps them, so that one shard is the
    unsharded run bit for bit; shard s >= 1 hashes each with (s,
    SHARD_STREAM)."""
    if shard == 0:
        return prior_seed, sim_seed
    return (stream_seed(prior_seed, shard, SHARD_STREAM),
            stream_seed(sim_seed, shard, SHARD_STREAM))


def shard_seeds(seed: int, index: int, shard: int) -> Tuple[int, int]:
    """(prior seed, simulation seed) of shard `shard` of wave `index` under
    base `seed`: a pure function of the three, whatever the shard count."""
    return split_seeds(*wave_seeds(seed, index), shard)


def make_simulator(dataset: CountryData, cfg: ABCConfig,
                   device="cuda", mob: Optional[torch.Tensor] = None) -> SimulatorFn:
    """The batched theta -> distance function on `device`; `mob` as in
    `ops.make_abc_sim` (a regional model's mobility buffer, shared). Under
    `cfg.autotune` its block is the tuning cache's winner."""
    if cfg.backend == "npe":
        raise ValueError(
            "backend='npe' has no theta -> distance simulator; it is an "
            "amortized estimator — use repro_torch.core.npe.train_npe / run_npe"
        )
    device = resolve_device(device)
    spec = get_model(cfg.model)
    if not dataset.compatible_with(spec):
        raise ValueError(
            f"dataset {dataset.name!r} holds {dataset.model!r} series; model "
            f"{spec.name!r} observes different channels"
        )
    if dataset.num_days < cfg.num_days:
        raise ValueError(
            f"dataset {dataset.name!r} has {dataset.num_days} days; "
            f"cfg.num_days is {cfg.num_days}"
        )
    if cfg.autotune:
        # the block from the measured tuning cache (a miss runs the search
        # once and persists it); the config comes back with autotune=False,
        # so the search's own probes build their simulators below
        from repro_torch.core import tuning

        cfg = tuning.resolve_tuned(dataset, cfg, device=device)
    observed = torch.as_tensor(
        np.ascontiguousarray(dataset.observed[:, : cfg.num_days], np.float32),
        device=device,
    )
    return ops.make_abc_sim(
        observed, population=dataset.population, a0=dataset.a0,
        r0=dataset.r0, d0=dataset.d0, model=spec, summary=cfg.summary_spec,
        distance=cfg.distance, block=cfg.block, schedule=cfg.schedule,
        mobility=resolved_mobility(cfg, spec), mob=mob,
    )


def abc_run_batch(
    prior: UniformBoxPrior, simulator: SimulatorFn, cfg: ABCConfig, device="cuda"
) -> Callable[[int, int], RunOutput]:
    """One wave as a function of its (prior seed, simulation seed)."""
    device = resolve_device(device)
    p = prior.dim

    def run(prior_seed: int, sim_seed: int) -> RunOutput:
        # theta [B, p] row-major; failed (NaN) simulations come back as +inf,
        # so they never count as accepted
        theta, dist = simulator.wave(prior, prior_seed, sim_seed, cfg.batch_size)
        if cfg.strategy == "outfeed":
            nc, cs = cfg.num_chunks, cfg.chunk_size
            flags = (dist <= cfg.tolerance).reshape(nc, cs).any(dim=1)
            return RunOutput(theta.reshape(nc, cs, p), dist.reshape(nc, cs), flags)
        vals, idx = torch.topk(dist, cfg.top_k, largest=False, sorted=True)
        return RunOutput(theta[idx], vals,
                         torch.zeros((0,), dtype=torch.bool, device=device))

    return run


# --------------------------------------------------------------------------
# Device-resident wave loop
# --------------------------------------------------------------------------

class WaveLoopOutput(NamedTuple):
    """What one call of a `WaveRunner` leaves on the device, in `repro`'s
    segment layout: one segment a shard, segment s holding `fill_counts[s]`
    valid rows. Each segment has `capacity + 1` rows; its last is the spare
    row where rejected rows land, and its content means nothing."""

    theta_segments: Tuple[torch.Tensor, ...]  # a shard's [capacity + 1, p], on its device
    dist_segments: Tuple[torch.Tensor, ...]  # a shard's [capacity + 1]
    n_accepted: torch.Tensor  # [1] int64: total accepted over the shards (may exceed the fills)
    waves_done: torch.Tensor  # [1] int64: waves of this call whose gate was open
    fill_counts: torch.Tensor  # [shards] int64: valid rows a segment (clamped to capacity)
    enqueued: int = 0  # waves this call enqueued, gated ones included
    #: what `read` still has to place in the segments (the pjit loop's,
    #: `core.distributed.PjitWaveRunner`); None elsewhere
    pending: Optional[list] = None
    #: the graph path's pinned host tensor that a replay fills with (waves
    #: done, accepted, valid rows); None on the eager path
    counts: Optional[torch.Tensor] = None

    @property
    def theta_buf(self) -> torch.Tensor:
        """The segments one after the other ([shards * (capacity + 1), p];
        one shard: its segment, no copy)."""
        return _joined(self.theta_segments)

    @property
    def dist_buf(self) -> torch.Tensor:
        return _joined(self.dist_segments)


def _joined(segments) -> torch.Tensor:
    if len(segments) == 1:
        return segments[0]
    return torch.cat([t.to(segments[0].device) for t in segments])


def wave_capacity(cfg: ABCConfig, batch_size: Optional[int] = None) -> int:
    """Accept-buffer rows a shard: never overflows within one wave. A wave
    only runs while accepted < target and adds at most one batch, so
    `target + batch - 1` bounds the fill; the last wave's overshoot is kept,
    as the host outfeed path keeps it."""
    return cfg.target_accepted + (batch_size or cfg.batch_size)


def _auto_device_loop(cfg: ABCConfig) -> bool:
    """auto: the device loop for outfeed runs whose accept buffer stays small."""
    if cfg.wave_loop == "device":
        return True
    if cfg.wave_loop == "host":
        return False
    return cfg.strategy == "outfeed" and wave_capacity(cfg) <= _AUTO_DEVICE_MAX_ROWS


def compact_accepted(th_buf: torch.Tensor, d_buf: torch.Tensor, fill: torch.Tensor,
                     theta: torch.Tensor, dist: torch.Tensor, accept: torch.Tensor,
                     capacity: int, words: Optional[torch.Tensor] = None):
    """Copy the accepted rows of a wave into the buffers' next free rows, in
    stream order, and return (th_buf, d_buf, new_fill).

    The buffers hold `capacity + 1` rows; row `capacity` is a spare whose
    content means nothing. As `repro`'s scatter drops out-of-bounds rows,
    accepted rows past the capacity are dropped, and `new_fill` (a new
    tensor; `fill` is not updated) counts every accepted row: callers clamp
    it to `capacity`. `fill` is an int64 tensor of shape [1]. Shared by the
    ABC wave loops and the SMC round; its launches are the span
    `abc.compact`.

    CUDA tensors take one launch of the compaction kernel
    (`kernels.compact`, counted by `COMPACT_KERNEL_LAUNCHES`; `words`, its
    status words where the caller keeps its own), which writes only the
    accepted rows; other tensors take `compact_plain`. Both give the same
    rows [0, capacity) and the same new fill.
    """
    global COMPACT_KERNEL_LAUNCHES
    with span("abc.compact"):
        if theta.device.type == "cuda":
            new_fill = compact.compact_rows(th_buf, d_buf, fill, theta, dist, accept, capacity,
                                            words)
            COMPACT_KERNEL_LAUNCHES += 1
            return th_buf, d_buf, new_fill
        return compact_plain(th_buf, d_buf, fill, theta, dist, accept, capacity)


def compact_plain(th_buf: torch.Tensor, d_buf: torch.Tensor, fill: torch.Tensor,
                  theta: torch.Tensor, dist: torch.Tensor, accept: torch.Tensor,
                  capacity: int):
    """`compact_accepted` in plain PyTorch, on any device: fixed shapes, no
    atomics and no data-dependent indexing, as every rejected row is
    written to the spare row `capacity`."""
    csum = torch.cumsum(accept, 0)  # int64
    slot = torch.where(accept, csum + (fill - 1), capacity).clamp_(max=capacity)
    th_buf.index_copy_(0, slot, theta)
    d_buf.index_copy_(0, slot, dist)
    return th_buf, d_buf, fill + csum[-1:]


def sync_counts(*counts: torch.Tensor, done: Optional[torch.cuda.Event] = None) -> list:
    """The device loops' one host sync a segment: the int64 count tensors
    as Python ints, in one copy; on the graph path (`done`, the event
    recorded after a replay) the wait for that event and a read of the one
    pinned host tensor that the replay copied its counts to. Counted by
    `HOST_SYNCS`, the span `abc.sync`."""
    global HOST_SYNCS
    with span("abc.sync"):
        HOST_SYNCS += 1
        if done is None:
            # analysis: allow(host-sync-in-wave-loop) — the loops' one sanctioned
            # sync a segment: one copy of the counts, then ints of host tensors
            return [int(c) for c in torch.cat(counts).cpu()]
        done.synchronize()  # the graph path's sync: the replay copied its counts
        # analysis: allow(host-sync-in-wave-loop) — ints of the pinned host tensor
        return counts[0].tolist()


def tolerance32(tolerance: float) -> float:
    """`tolerance` rounded to float32 once: the threshold that the host
    loop's float32 comparisons (torch's and numpy's) apply."""
    with np.errstate(over="ignore"):
        return float(np.float32(tolerance))


def split_state(state: "ABCState", shards: int, capacity: int):
    """The state's accepted rows split over `shards` segments as `repro`'s
    `WaveRunner.init` splits them (`np.array_split`, in order): a list of
    (theta, dist) a shard. Raises when a segment would overflow."""
    theta, dist = state.to_arrays()
    n = theta.shape[0]
    parts = []
    for idx in np.array_split(np.arange(n), shards):
        if idx.size > capacity:
            what = f"{capacity} rows" if shards == 1 else f"{shards} x {capacity} rows"
            raise ValueError(f"resumed state ({n} accepted) overflows the wave buffer "
                             f"({what}); raise target/batch")
        parts.append((theta[idx], dist[idx]))
    return parts


def segment_buffers(theta: np.ndarray, dist: np.ndarray, capacity: int, n_params: int,
                    device: torch.device):
    """One segment's device buffers (`capacity + 1` rows) seeded with the
    rows given, and its fill as an int64 tensor of shape [1]."""
    n = theta.shape[0]
    th_buf = torch.zeros((capacity + 1, n_params), dtype=torch.float32, device=device)
    d_buf = torch.full((capacity + 1,), float("inf"), dtype=torch.float32, device=device)
    if n:
        th_buf[:n] = torch.from_numpy(np.ascontiguousarray(theta)).to(device)
        d_buf[:n] = torch.from_numpy(np.ascontiguousarray(dist)).to(device)
    return th_buf, d_buf, torch.full((1,), n, dtype=torch.int64, device=device)


class _SegmentGraph:
    """The graph path's state, one a runner (`WaveRunner`): the accept
    buffers (`capacity + 1` rows), the fill, the seed table and the
    compaction's status words that the segment's CUDA graph reads and
    writes; the pinned host tensors of the seeds it copies in and of the
    counts it copies out; and, once captured, the graph, its output, the C
    name of its wave entry and the event recorded after its last replay."""

    def __init__(self, capacity: int, n_params: int, batch: int, device: torch.device):
        self.waves = SEGMENT_WAVES
        self.th = torch.zeros((capacity + 1, n_params), dtype=torch.float32, device=device)
        self.d = torch.full((capacity + 1,), float("inf"), dtype=torch.float32, device=device)
        self.fill = torch.zeros((1,), dtype=torch.int64, device=device)
        # wave i's (simulation seed, prior seed) as uint32 bits
        self.seeds = torch.zeros((self.waves, 2), dtype=torch.int32, device=device)
        self.seeds_host = torch.zeros((self.waves, 2), dtype=torch.int32, pin_memory=True)
        self.seeds_view = self.seeds_host.numpy().view(np.uint32)  # written before a replay
        self.counts_host = torch.zeros((3,), dtype=torch.int64, pin_memory=True)
        # the graph's own, so that no other launch grows or frees them
        self.words = compact.status_words(device, batch)
        self.graph = self.out = self.entry = None
        self.done = torch.cuda.Event()

    def reset(self):
        """The carry of an empty state: the buffers as `segment_buffers`
        makes them (theta 0, distances +inf, fill 0), reset in place."""
        self.th.zero_()
        self.d.fill_(float("inf"))
        self.fill.zero_()
        return self.carry()

    def carry(self):
        return [self.th], [self.d], [self.fill], self.fill

    def holds(self, carry) -> bool:
        """Whether `carry` lies in these buffers."""
        return carry[0][0] is self.th and carry[1][0] is self.d


@dataclasses.dataclass
class WaveRunner:
    """The device-resident wave loop and its buffer layout: one shard on
    `sim`, or the lockstep reference of `len(shard_sims)` shards in one
    process (`core.scaling.make_reference_wave_runner`), shard s on
    `shard_sims[s]`'s device with a batch of `cfg.batch_size / shards`.

    `init(state)` makes the carry on the shards' devices from a (possibly
    resumed) state; `runner(seed, run_idx0, carry, max_waves)` enqueues
    `max_waves` gated waves and returns without waiting; `carry_of(out)`
    is the carry for the next call; `read(out)` is its one host sync;
    `harvest(out, state, fill)` copies the accepted rows to the state.
    Each call must be read before the next.

    The graph path: on a CUDA device with one shard, `init` of an empty state
    resets buffers of the runner's own in place, and a segment of
    `SEGMENT_WAVES` waves on them (`takes_graph`) replays one CUDA graph once
    the runner has run one such segment eagerly: the graph, captured at the
    first, holds the segment's waves as the eager loop enqueues them, each
    wave's entry reading its seeds from a device table that the graph's first
    copy fills from pinned memory, and ends with the carried fill and a copy
    of the counts to pinned memory, which `read` reads after waiting for the
    replay. A resumed state, a shorter segment, CPU
    tensors, several shards and a runner's first segments take the eager path,
    as does a subclass with a loop of its own. Both paths give the same bits.
    """

    sim: SimulatorFn
    prior: UniformBoxPrior
    cfg: ABCConfig
    capacity: int  # rows a segment
    n_params: int
    #: one simulator a shard (the lockstep reference); empty: one shard on `sim`
    shard_sims: Tuple[SimulatorFn, ...] = ()
    #: the graph path's buffers and graph (`_SegmentGraph`), made by the
    #: first `init` of an empty state that may take it
    _graph: Optional[_SegmentGraph] = dataclasses.field(default=None, init=False, repr=False,
                                                        compare=False)
    #: segments of SEGMENT_WAVES waves on a CUDA device with one shard that
    #: this runner enqueued eagerly
    _eager_segments: int = dataclasses.field(default=0, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.sim.device

    @property
    def sims(self) -> Tuple[SimulatorFn, ...]:
        return self.shard_sims or (self.sim,)

    @property
    def shards(self) -> int:
        return len(self.sims)

    def _graph_capable(self) -> bool:
        """One shard on a CUDA device, on this class's own loop: a subclass
        with a loop of its own (`core.distributed`'s) keeps its buffers."""
        return (self.shards == 1 and self.sims[0].device.type == "cuda"
                and type(self).__call__ is WaveRunner.__call__)

    def takes_graph(self, max_waves: int) -> bool:
        """Whether a segment of `max_waves` waves on the runner's own buffers
        replays the graph: a full segment of `SEGMENT_WAVES` waves on a CUDA
        device with one shard, after one such segment run eagerly, so that
        a runner made for a single call never captures one."""
        return (max_waves == SEGMENT_WAVES and self._eager_segments >= 1
                and self._graph_capable())

    def init(self, state: "ABCState"):
        """Device buffers seeded from the state's accepted rows, split over
        the segments as `repro`'s `WaveRunner.init` splits them (in order
        for one shard). The carry is (theta segments, dist segments, fills,
        total accepted). An empty state on a CUDA device with one shard
        resets the graph path's buffers in place."""
        if not state.n_accepted and self._graph_capable():
            if self._graph is None:
                self._graph = _SegmentGraph(self.capacity, self.n_params, self.cfg.batch_size,
                                            self.sims[0].device)
            return self._graph.reset()
        segs = [segment_buffers(th, d, self.capacity, self.n_params, sim.device)
                for (th, d), sim in zip(split_state(state, self.shards, self.capacity),
                                        self.sims)]
        th_segs, d_segs, fills = (list(x) for x in zip(*segs))
        if self.shards == 1:
            return th_segs, d_segs, fills, fills[0]
        n = torch.full((1,), state.n_accepted, dtype=torch.int64, device=self.device)
        return th_segs, d_segs, fills, n

    def __call__(self, seed: int, run_idx0: int, carry, max_waves: int) -> WaveLoopOutput:
        """Enqueue waves run_idx0 .. run_idx0 + max_waves - 1 of `seed`: a
        replay of the segment's graph where the carry lies in the graph's
        buffers and `takes_graph` holds (the span `abc.replay`), else the
        waves one by one (`_enqueue`). Nothing here waits for the device."""
        graph = self._graph
        if graph is not None and graph.holds(carry) and self.takes_graph(max_waves):
            return self._replay(seed, run_idx0, carry[2][0])
        if max_waves == SEGMENT_WAVES and self._graph_capable():
            self._eager_segments += 1
        return self._enqueue(seed, run_idx0, carry, max_waves)

    def _enqueue(self, seed: int, run_idx0: int, carry, max_waves: int,
                 graph: Optional[_SegmentGraph] = None) -> WaveLoopOutput:
        """Enqueue the waves one by one. Each wave reads the gate `accepted <
        target` once, an int32 tensor that the kernel reads when it runs;
        then each shard draws its sub-batch with its own seeds
        (`shard_seeds`), compacts its rows with dist <= tolerance (in
        float32) and an open gate into its segment, and the shards' counts
        are summed into the total. Under capture (`graph`, one shard), wave
        i's entry reads its seeds from row i of the graph's seed table and
        the compaction takes the graph's status words. Each wave is the span
        `abc.wave`."""
        th_segs, d_segs, fills, n = (list(carry[0]), list(carry[1]), list(carry[2]),
                                     carry[3])
        cfg, sims = self.cfg, self.sims
        batch = cfg.batch_size // len(sims)
        tol = tolerance32(cfg.tolerance)
        scratch = [(torch.empty((batch, self.n_params), dtype=torch.float32, device=s.device),
                    torch.empty((batch,), dtype=torch.float32, device=s.device))
                   for s in sims]
        waves = torch.zeros((1,), dtype=torch.int64, device=self.device)
        away = [sim.device != self.device for sim in sims]
        words = None if graph is None else graph.words
        for i in range(max_waves):
            with span("abc.wave"):
                active = n < cfg.target_accepted
                total = n
                for s, sim in enumerate(sims):
                    act = active.to(sim.device) if away[s] else active
                    theta, dist = scratch[s]
                    sim.wave(self.prior, *shard_seeds(seed, run_idx0 + i, s), batch,
                             gate=act.to(torch.int32), out=(theta, dist),
                             seeds=None if graph is None else graph.seeds[i])
                    accept = (dist <= tol) & act
                    th_segs[s], d_segs[s], new_fill = compact_accepted(
                        th_segs[s], d_segs[s], fills[s], theta, dist, accept, self.capacity,
                        words)
                    if len(sims) > 1:
                        total = total + (new_fill - fills[s]).to(self.device)
                    fills[s] = new_fill
                # one shard: the total accepted is the fill before clamping
                n = fills[0] if len(sims) == 1 else total
                waves += active
        clamped = [f.clamp(max=self.capacity) for f in fills]
        return WaveLoopOutput(tuple(th_segs), tuple(d_segs), n, waves,
                              _joined(clamped), max_waves)

    def _capture(self) -> None:
        """Capture a segment on the graph path's buffers as a CUDA graph,
        on a stream of its own; nothing runs. The launches it records are
        counted at each replay."""
        global GRAPH_CAPTURES, COMPACT_KERNEL_LAUNCHES
        g, device = self._graph, self.sims[0].device
        stream = torch.cuda.Stream(device)
        launches, compactions = dict(abc_sim.ENTRY_LAUNCHES), COMPACT_KERNEL_LAUNCHES
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            g.seeds.copy_(g.seeds_host, non_blocking=True)
            out = self._enqueue(0, 0, g.carry(), g.waves, graph=g)
            g.fill.copy_(out.n_accepted)
            g.counts_host.copy_(torch.cat((out.waves_done, out.n_accepted, out.fill_counts)),
                                non_blocking=True)
        abc_sim.ENTRY_LAUNCHES.clear()
        abc_sim.ENTRY_LAUNCHES.update(launches)
        COMPACT_KERNEL_LAUNCHES = compactions
        g.graph, g.entry = graph, self.sims[0].entry("wave", self.cfg.batch_size)
        g.out = WaveLoopOutput((g.th,), (g.d,), g.fill, out.waves_done, out.fill_counts,
                               g.waves, counts=g.counts_host)
        GRAPH_CAPTURES += 1

    def _replay(self, seed: int, run_idx0: int, fill: torch.Tensor) -> WaveLoopOutput:
        """One replay of the segment's graph (captured at the first) for
        waves run_idx0 .. of `seed`, from the carried `fill`."""
        global GRAPH_REPLAYS, COMPACT_KERNEL_LAUNCHES
        g = self._graph
        if g.graph is None:
            self._capture()
        # the last replay was read, so its copy of the seeds is done; shard
        # 0's seeds are the wave's own (`shard_seeds`)
        g.seeds_view[:] = segment_seeds(seed, run_idx0, g.waves)
        if fill is not g.fill:  # an eager segment's fill
            g.fill.copy_(fill)
        with span("abc.replay"):
            g.graph.replay()
        g.done.record()
        GRAPH_REPLAYS += 1
        abc_sim.record_launches(g.entry, g.waves)
        COMPACT_KERNEL_LAUNCHES += g.waves
        return g.out

    def carry_of(self, out: WaveLoopOutput):
        """The next call's carry. A shard's fill is carried clamped, as
        `repro`'s is: past the capacity every row lands in the spare row
        either way."""
        if self.shards == 1:
            return [out.theta_segments[0]], [out.dist_segments[0]], [out.n_accepted], \
                out.n_accepted
        fills = [out.fill_counts[s:s + 1].to(sim.device) for s, sim in enumerate(self.sims)]
        return list(out.theta_segments), list(out.dist_segments), fills, out.n_accepted

    def read(self, out: WaveLoopOutput):
        """(waves done, accepted, valid rows) of a call: its one host sync.
        The valid rows are an int for one shard and a tuple of one count a
        segment for more, as `repro`'s carry holds them. On the card it
        records the gated launches beside the entry's launches
        (`AbcSim.record_gated`)."""
        if out.counts is not None:  # a replay copied its counts to pinned memory
            waves, n, *fills = sync_counts(out.counts, done=self._graph.done)
        else:
            waves, n, *fills = sync_counts(out.waves_done, out.n_accepted, out.fill_counts)
        for sim in self.sims:
            sim.record_gated("wave", self.cfg.batch_size // self.shards, out.enqueued - waves)
        return waves, n, fills[0] if self.shards == 1 else tuple(fills)

    def harvest(self, out: WaveLoopOutput, state: "ABCState", fill) -> None:
        """Replace the state's accepted set with each segment's first valid
        rows, in shard order: the buffers are cumulative (a resumed prefix
        included), so this replaces rather than appends."""
        fills = (fill,) if isinstance(fill, int) else fill
        state.accepted_theta, state.accepted_dist = [], []
        for th, d, c in zip(out.theta_segments, out.dist_segments, fills):
            if c:
                state.accepted_theta.append(th[:c].cpu().numpy())
                state.accepted_dist.append(d[:c].cpu().numpy())

    def segments(self, out: WaveLoopOutput):
        """`repro`'s buffer layout on the host: (theta [shards * capacity, p],
        dist [shards * capacity], fills [shards]), each segment without its
        spare row. A checkpoint's tree, and what the sharded runners are
        held to bitwise."""
        cap = self.capacity
        return (np.concatenate([t[:cap].cpu().numpy() for t in out.theta_segments]),
                np.concatenate([d[:cap].cpu().numpy() for d in out.dist_segments]),
                out.fill_counts.cpu().numpy())


def make_wave_runner(prior: UniformBoxPrior, simulator: SimulatorFn,
                     cfg: ABCConfig) -> WaveRunner:
    """The device wave loop of `simulator` (on its series' device)."""
    return WaveRunner(sim=simulator, prior=prior, cfg=cfg, capacity=wave_capacity(cfg),
                      n_params=prior.dim)


@dataclasses.dataclass
class ABCState:
    """Resumable sampler state: the same `.npz` fields as `repro`'s, so a
    checkpoint written by either package resumes in the other."""

    run_idx: int = 0
    simulations: int = 0
    accepted_theta: list = dataclasses.field(default_factory=list)
    accepted_dist: list = dataclasses.field(default_factory=list)
    #: parameter dimension; gives the empty-case arrays a concrete shape
    n_params: Optional[int] = None

    @property
    def n_accepted(self) -> int:
        return sum(int(t.shape[0]) for t in self.accepted_theta)

    def to_arrays(self):
        if not self.accepted_theta:
            return (
                np.zeros((0, self.n_params or 0), np.float32),
                np.zeros((0,), np.float32),
            )
        return (
            np.concatenate(self.accepted_theta, axis=0),
            np.concatenate(self.accepted_dist, axis=0),
        )

    def save(self, path: str) -> None:
        """Atomic save: an interrupted save never leaves a truncated file."""
        th, d = self.to_arrays()
        with atomic_write(path, "wb") as f:
            np.savez(
                f, run_idx=self.run_idx, simulations=self.simulations,
                theta=th, dist=d,
            )

    _REQUIRED_KEYS = ("run_idx", "simulations", "theta", "dist")

    @staticmethod
    def load(path: str) -> "ABCState":
        """Load a checkpoint; corrupt or partial files raise ValueError, a
        missing file raises FileNotFoundError."""
        try:
            z = np.load(path, allow_pickle=False)
            missing = [k for k in ABCState._REQUIRED_KEYS if k not in z.files]
            if missing:
                raise ValueError(f"missing arrays {missing}")
            theta = np.asarray(z["theta"], np.float32)
            dist = np.asarray(z["dist"], np.float32)
            if theta.ndim != 2 or dist.shape != (theta.shape[0],):
                raise ValueError(
                    f"inconsistent shapes theta={theta.shape} dist={dist.shape}"
                )
            st = ABCState(
                run_idx=int(z["run_idx"]),
                simulations=int(z["simulations"]),
                n_params=int(theta.shape[1]),
            )
        except FileNotFoundError:
            raise
        except (zipfile.BadZipFile, OSError, KeyError, ValueError) as e:
            raise ValueError(
                f"corrupt or incomplete ABC checkpoint {path!r} ({e}); it was "
                "probably truncated by an interrupted save — delete it to "
                "restart from scratch"
            ) from e
        if theta.shape[0]:
            st.accepted_theta = [theta]
            st.accepted_dist = [dist]
        return st


def writes_files() -> bool:
    """Whether this process writes run files: rank 0 of an initialised
    process group, or a process outside one."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _harvest(out: RunOutput, cfg: ABCConfig, state: ABCState) -> int:
    """Copy what the strategy marked to the host, keep dist <= tolerance and
    append it to the state. Returns the number harvested."""
    n_new = 0
    if cfg.strategy == "outfeed":
        flags = out.chunk_flags.cpu().numpy()  # [n_chunks], a tiny copy
        for ci in np.nonzero(flags)[0]:
            d = out.dist[ci].cpu().numpy()  # one chunk's copy, as the outfeed
            th = out.theta[ci].cpu().numpy()
            m = d <= cfg.tolerance
            if m.any():
                state.accepted_theta.append(th[m])
                state.accepted_dist.append(d[m])
                n_new += int(m.sum())
    else:
        d = out.dist.cpu().numpy()
        th = out.theta.cpu().numpy()
        m = d <= cfg.tolerance
        if m.any():
            state.accepted_theta.append(th[m])
            state.accepted_dist.append(d[m])
            n_new += int(m.sum())
        # as in the paper, samples beyond the k per wave are lost
    return n_new


def run_abc(
    dataset: CountryData,
    cfg: ABCConfig,
    seed: int = 0,
    prior: Optional[UniformBoxPrior] = None,
    state: Optional[ABCState] = None,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
    device="cuda",
    wave_runner: Optional[WaveRunner] = None,
    run_fn: Optional[Callable[[int, int], RunOutput]] = None,
) -> Posterior:
    """Run waves until `target_accepted` posterior samples or `max_runs`
    waves: on the device loop where `cfg.wave_loop` picks it (or a
    `wave_runner` is given), else on the host loop (on `run_fn` where one
    is given, such as `core.distributed`'s sharded runner). Wave i is
    `wave_seeds(seed, i)` in both. Under an initialised process group only
    rank 0 writes the checkpoint; every rank keeps the same segments.
    `backend="npe"` runs no waves: it trains an estimator and samples it
    (`core.npe.run_npe`)."""
    if cfg.backend == "npe":
        # the amortized backend has no wave loop: train, then one forward
        # pass; the wave loop's knobs do not apply
        if wave_runner is not None or run_fn is not None or state is not None:
            raise ValueError(
                "backend='npe' does not run waves; wave_runner / run_fn / "
                "resumable state do not apply"
            )
        from repro_torch.core import npe

        return npe.run_npe(dataset, cfg, seed, prior=prior, verbose=verbose, device=device)
    spec = get_model(cfg.model)
    prior = prior or schedule_prior(spec, cfg.schedule)
    state = state or ABCState()
    if state.n_params is None:
        state.n_params = prior.dim
    elif state.n_params != prior.dim:
        raise ValueError(
            f"resumed state holds {state.n_params}-parameter samples but model "
            f"{spec.name!r} (with its schedule) has {prior.dim} — wrong checkpoint?"
        )
    with span("abc.posterior"):
        if wave_runner is None and run_fn is None and _auto_device_loop(cfg):
            wave_runner = make_wave_runner(prior, make_simulator(dataset, cfg, device), cfg)
        if wave_runner is not None:
            return _run_abc_device(cfg, seed, state, wave_runner, spec,
                                   checkpoint_every=checkpoint_every,
                                   checkpoint_path=checkpoint_path, verbose=verbose)
        run = run_fn or abc_run_batch(prior, make_simulator(dataset, cfg, device), cfg,
                                      device)
        return _run_abc_host(cfg, seed, state, run, spec, checkpoint_every=checkpoint_every,
                             checkpoint_path=checkpoint_path, verbose=verbose)


def _run_abc_host(
    cfg: ABCConfig,
    seed: int,
    state: ABCState,
    run: Callable[[int, int], RunOutput],
    spec,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
) -> Posterior:
    """The host loop: one wave at a time, each harvested (`_harvest`, the
    span `abc.harvest`) before the next is started; the state is saved
    every `checkpoint_every` waves when checkpointing."""
    t0 = time.time()
    while state.n_accepted < cfg.target_accepted and state.run_idx < cfg.max_runs:
        out = run(*wave_seeds(seed, state.run_idx))
        with span("abc.harvest"):
            _harvest(out, cfg, state)  # its first copy waits for the wave
        state.run_idx += 1
        state.simulations += cfg.batch_size
        if verbose and state.run_idx % 50 == 0:
            print(
                f"[abc] run {state.run_idx}: accepted {state.n_accepted}/"
                f"{cfg.target_accepted}"
            )
        if (checkpoint_every and checkpoint_path and state.run_idx % checkpoint_every == 0
                and writes_files()):
            state.save(checkpoint_path)

    theta, dist = state.to_arrays()
    return Posterior(
        theta=theta,
        distances=dist,
        tolerance=cfg.tolerance,
        param_names=run_param_names(cfg, spec),
        runs=state.run_idx,
        simulations=state.simulations,
        wall_time_s=time.time() - t0,
    )


def _run_abc_device(
    cfg: ABCConfig,
    seed: int,
    state: ABCState,
    wave_runner: WaveRunner,
    spec,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
) -> Posterior:
    """The device loop: segments of up to `SEGMENT_WAVES` waves, each
    bounded by the remaining `max_runs` and by the next multiple of
    `checkpoint_every`, with one host sync a segment; the state is saved
    after every segment when checkpointing. Spans: `abc.init` (the
    buffers), `abc.segment` (a segment's enqueue), `abc.harvest` (the
    accepted rows to the host); the sync is `abc.sync`."""
    t0 = time.time()
    with span("abc.init"):
        carry = wave_runner.init(state)
    while state.n_accepted < cfg.target_accepted and state.run_idx < cfg.max_runs:
        seg = min(SEGMENT_WAVES, cfg.max_runs - state.run_idx)
        if checkpoint_every and checkpoint_path:
            seg = min(seg, checkpoint_every - state.run_idx % checkpoint_every)
        with span("abc.segment"):
            out = wave_runner(seed, state.run_idx, carry, seg)
        waves, _, fill = wave_runner.read(out)  # the segment's one host sync
        with span("abc.harvest"):
            wave_runner.harvest(out, state, fill)
        carry = wave_runner.carry_of(out)
        state.run_idx += waves
        state.simulations += waves * cfg.batch_size
        if verbose:
            print(f"[abc] run {state.run_idx}: accepted {state.n_accepted}/"
                  f"{cfg.target_accepted} (device wave loop)")
        if checkpoint_every and checkpoint_path and writes_files():
            state.save(checkpoint_path)
        if waves == 0:  # nothing left to run; avoid a spin
            break

    theta, dist = state.to_arrays()
    return Posterior(
        theta=theta,
        distances=dist,
        tolerance=cfg.tolerance,
        param_names=run_param_names(cfg, spec),
        runs=state.run_idx,
        simulations=state.simulations,
        wall_time_s=time.time() - t0,
    )


def calibrate_tolerance(
    dataset: CountryData,
    cfg: ABCConfig,
    seed: int = 0,
    quantile: float = 1e-3,
    n_pilot: int = 65_536,
    prior: Optional[UniformBoxPrior] = None,
    device="cuda",
    simulator: Optional[SimulatorFn] = None,
) -> float:
    """A tolerance at the `quantile` of a pilot of prior-predictive
    distances, so that the expected acceptance rate is set beforehand:
    expected waves ~= target_accepted / (quantile * batch_size). The pilot
    runs on `simulator` where one is given (made from `dataset` and `cfg`
    on its device), else on a new one on `device`."""
    prior = prior or schedule_prior(get_model(cfg.model), cfg.schedule)
    simulator = simulator or make_simulator(dataset, cfg, resolve_device(device))
    per_wave = min(n_pilot, cfg.batch_size)
    dists = []
    for w in range(max(1, n_pilot // per_wave)):
        _, d = simulator.wave(prior, stream_seed(seed, w, PILOT_PRIOR_STREAM),
                              stream_seed(seed, w, PILOT_SIM_STREAM), per_wave)
        d = d.cpu().numpy()
        dists.append(d[np.isfinite(d)])
    return float(np.quantile(np.concatenate(dists), quantile))
