"""Scale-out of parallel ABC on `torch.distributed` (port of
`repro.core.distributed`, paper §4.5, Table 7).

Execution model:

  * **Ranks and devices.** A shard is a rank of a `torch.distributed`
    process group. On `device="cuda"` rank r drives `cuda:LOCAL_RANK` (a
    rank whose LOCAL_RANK has no card raises) and the backend is NCCL; on
    `device="cpu"` the backend is gloo, which is what the tests use. The
    backend follows the device and nothing else: nothing tries NCCL and then
    carries on with gloo, and nothing runs on the CPU because it found no
    card. The entry points take the group given, else the default group when
    one is initialised (torchrun, or a caller's); with none they form one
    (`process_group`): from torchrun's environment, or, without it, a world
    of 1 from a `file://` store in a temporary directory.
  * **One small collective a wave.** The device loops' gate reads the
    global accepted count, so each wave all-reduces an int64 device tensor
    of counts: `repro`'s `count_all=psum`. On NCCL the all-reduce is ordered
    on the streams; nothing here reads it on the host or waits on its work
    object, so the device loops keep their one host sync a segment
    (`core.abc.HOST_SYNCS`).
  * **Gathers.** Rows are gathered once a segment, at the host re-entry,
    so every rank holds the same `ABCState` and returns the same
    `Posterior`. Over gloo the gathers go through host tensors.

Two styles, as in `repro` (`make_runner` and `make_wave_runner` dispatch on
`style`), each with a host loop (one wave a call, the `RunOutput` of
`core.abc.abc_run_batch` with the global accepted count beside it) and a
device loop (`core.abc.WaveRunner`'s contract):

  * **shard_map**, the paper's per-device replica (`make_shardmap_runner`,
    `make_shardmap_wave_runner`): rank r runs B / n samples a wave with its
    own seeds, `core.abc.shard_seeds(seed, i, r)`; shard 0 keeps
    `wave_seeds(seed, i)`, so a world of 1 is the unsharded `run_abc` bit
    for bit, and an N-rank run is bitwise the lockstep reference of N shards
    in one process (`core.scaling.make_reference_wave_runner`). The layout
    is `repro`'s: a segment of `wave_capacity(cfg, B / n)` rows a shard,
    `fill_counts` of shape [shards], a resumed state split over the
    segments by `np.array_split` (`core.abc.split_state`), the segments
    gathered in rank order. The collective a wave is the all-reduce of this
    rank's count. `repro` folds the device index into a threefry key
    instead; the two packages agree by statistics.
  * **pjit**, GSPMD's one logical wave (`make_pjit_runner`,
    `make_pjit_wave_runner`): rank r draws rows [r·B/n, (r+1)·B/n) of the
    single-device wave, with the wave's own seeds at sample offset r·B/n
    (the `offset` of the `abc_sim` wave entries), so N ranks give the
    single-device run's samples, accepted set and posterior bit for bit.
    The device loop keeps a single-device state on every rank (one segment
    of `wave_capacity(cfg)` rows, `fill_counts` of shape [1]), so its
    states and the unsharded run's resume in each other. The collective a
    wave is the all-reduce of a vector of the n ranks' counts (each rank
    adds its own at its rank), which gives every rank the exclusive prefix
    of the ranks before it: a rank's accepted rows keep their single-device
    positions, and the segment's rows are gathered and placed by those
    positions once a segment (`PjitWaveRunner.read`).

`spawn_ranks` runs a function on N ranks of this host, as the tests and
`chip_smoke.py` do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.abc import (
    ABCConfig,
    RunOutput,
    SimulatorFn,
    WaveLoopOutput,
    WaveRunner,
    compact_accepted,
    make_simulator,
    segment_buffers,
    shard_seeds,
    split_seeds,
    split_state,
    sync_counts,
    tolerance32,
    wave_capacity,
    wave_seeds,
)
from repro_torch.core.priors import UniformBoxPrior, schedule_prior
from repro_torch.device import resolve_device
from repro_torch.epi.models import get_model
from repro_torch.ioutils import atomic_write
from repro_torch.runtime.trace import span

STYLES = ("shard_map", "pjit")


def backend_for(device) -> str:
    """The backend of a group of `device`'s ranks: NCCL for a card, gloo for
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """The device this rank drives: `cuda:LOCAL_RANK` for "cuda" (made the
    current card), a `cuda:k` or the CPU as given."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK={local} but this host has {torch.cuda.device_count()} "
                    "CUDA devices; launch at most one rank a card (torchrun "
                    "--nproc-per-node)"
                )
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return dev


_OWNED_STORE: Optional[str] = None


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def process_group(group=None, device="cuda"):
    """`group`, else the default group, initialised here when there is none:
    from torchrun's environment, or a world of 1 from a `file://` store in a
    temporary directory. The backend follows `device`."""
    global _OWNED_STORE
    if group is not None:
        return group
    if not dist.is_initialized():
        dev = rank_device(device)
        backend = backend_for(dev)
        # NCCL is told its card (no guess at the first barrier)
        kw = {"device_id": dev} if backend == "nccl" else {}
        if _torchrun_env():
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            _OWNED_STORE = tempfile.mkdtemp(prefix="repro_torch_world_")
            dist.init_process_group(backend, init_method=f"file://{_OWNED_STORE}/store",
                                    rank=0, world_size=1, **kw)
    return dist.group.WORLD


@contextlib.contextmanager
def world(device="cuda"):
    """The default group for a block (`process_group(None, device)`); a
    group that the block initialised is destroyed when it ends."""
    global _OWNED_STORE
    owned = not dist.is_initialized()
    group = process_group(None, device)
    try:
        yield group
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
            if _OWNED_STORE is not None:
                shutil.rmtree(_OWNED_STORE, ignore_errors=True)
                _OWNED_STORE = None


def data_axes(group) -> Tuple[int, ...]:
    """The group's ranks (every rank is a data shard: ABC is pure data
    parallelism)."""
    return tuple(dist.get_process_group_ranks(group))


def _shards_of(group, cfg) -> Tuple[int, int]:
    n, shard = dist.get_world_size(group), dist.get_rank(group)
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by {n} devices")
    return n, shard


def gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (one shape on every rank), in rank order; through
    host tensors over gloo."""
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _check_style(style: str) -> None:
    if style not in STYLES:
        raise ValueError(f"unknown runner style {style!r}")


def _rank_simulator(dataset, cfg: ABCConfig, dev, group) -> SimulatorFn:
    """This rank's simulator. Its launches draw B / n samples, so under
    `cfg.autotune` the block is the tuning cache's winner at that batch."""
    n = dist.get_world_size(group)
    b = cfg.batch_size // n if cfg.batch_size % n == 0 else cfg.batch_size
    return make_simulator(dataset, dataclasses.replace(cfg, batch_size=b, chunk_size=b,
                                                       strategy="outfeed"), dev)


def make_runner(group, dataset, cfg: ABCConfig, style: str = "shard_map", device="cuda"):
    """The sharded host-loop runner of `style` from the config alone, on
    this rank's device (`rank_device`) and `group` (`process_group`)."""
    _check_style(style)
    dev = rank_device(device)
    group = process_group(group, dev)
    prior = schedule_prior(get_model(cfg.model), cfg.schedule)
    maker = make_shardmap_runner if style == "shard_map" else make_pjit_runner
    return maker(group, prior, _rank_simulator(dataset, cfg, dev, group), cfg)


def make_wave_runner(group, dataset, cfg: ABCConfig, style: str = "shard_map",
                     device="cuda") -> WaveRunner:
    """The sharded device wave loop of `style` (the multi-rank analogue of
    `core.abc.make_wave_runner`), on this rank's device and `group`."""
    _check_style(style)
    dev = rank_device(device)
    group = process_group(group, dev)
    prior = schedule_prior(get_model(cfg.model), cfg.schedule)
    maker = make_shardmap_wave_runner if style == "shard_map" else make_pjit_wave_runner
    return maker(group, prior, _rank_simulator(dataset, cfg, dev, group), cfg)


def make_shardmap_runner(group, prior: UniformBoxPrior, simulator: SimulatorFn,
                         cfg: ABCConfig) -> Callable[[int, int], RunOutput]:
    """One wave a call, `cfg.batch_size` the global batch: this rank draws
    its `B / n` rows with its shard's seeds, and the call returns every
    rank's chunks (outfeed) or top-k rows, concatenated in rank order, with
    the global accepted count (`RunOutput.accept_count`), on every rank.
    Takes the wave's own (prior seed, simulation seed), as
    `core.abc.abc_run_batch`'s runner does."""
    n, shard = _shards_of(group, cfg)
    local = dataclasses.replace(cfg, batch_size=cfg.batch_size // n,
                                chunk_size=min(cfg.chunk_size, cfg.batch_size // n))
    p, dev = prior.dim, simulator.device

    def run(prior_seed: int, sim_seed: int) -> RunOutput:
        theta, d = simulator.wave(prior, *split_seeds(prior_seed, sim_seed, shard),
                                  local.batch_size)
        count = (d <= cfg.tolerance).sum(dtype=torch.int64).reshape(1)
        dist.all_reduce(count, group=group)
        if cfg.strategy == "outfeed":
            nc, cs = local.num_chunks, local.chunk_size
            th_c, d_c = theta.reshape(nc, cs, p), d.reshape(nc, cs)
            flags = (d_c <= cfg.tolerance).any(dim=1)
        else:
            d_c, idx = torch.topk(d, cfg.top_k, largest=False, sorted=True)
            th_c, flags = theta[idx], torch.zeros((0,), dtype=torch.bool, device=dev)
        return RunOutput(*(torch.cat(gather(x, group)).to(dev) for x in (th_c, d_c, flags)),
                         count)

    return run


def effective_chunk_flags(out: RunOutput) -> torch.Tensor:
    return out.chunk_flags


@dataclasses.dataclass
class ShardedWaveRunner(WaveRunner):
    """The device wave loop of this rank's shard of `group`: its segment
    stays on its device, and the shards meet once a wave in the count's
    all-reduce and once a segment in `read` and `harvest`."""

    group: object = None
    shard: int = 0
    n_shards: int = 1

    @property
    def shards(self) -> int:
        return self.n_shards

    def init(self, state):
        """This shard's segment of the state, split as `repro` splits it."""
        theta, d = split_state(state, self.n_shards, self.capacity)[self.shard]
        th_buf, d_buf, fill = segment_buffers(theta, d, self.capacity, self.n_params,
                                              self.device)
        n = torch.full((1,), state.n_accepted, dtype=torch.int64, device=self.device)
        return [th_buf], [d_buf], [fill], n

    def __call__(self, seed: int, run_idx0: int, carry, max_waves: int) -> WaveLoopOutput:
        (th_buf,), (d_buf,), (fill,), n = carry
        cfg, dev = self.cfg, self.device
        batch = cfg.batch_size // self.n_shards
        tol = tolerance32(cfg.tolerance)
        theta = torch.empty((batch, self.n_params), dtype=torch.float32, device=dev)
        dist_ = torch.empty((batch,), dtype=torch.float32, device=dev)
        waves = torch.zeros((1,), dtype=torch.int64, device=dev)
        for i in range(max_waves):
            with span("abc.wave"):
                active = n < cfg.target_accepted
                self.sim.wave(self.prior, *shard_seeds(seed, run_idx0 + i, self.shard), batch,
                              gate=active.to(torch.int32), out=(theta, dist_))
                accept = (dist_ <= tol) & active
                th_buf, d_buf, new_fill = compact_accepted(th_buf, d_buf, fill, theta, dist_,
                                                           accept, self.capacity)
                count = new_fill - fill
                dist.all_reduce(count, group=self.group)  # the one collective a wave
                n = n + count
                fill = new_fill
                waves += active
        return WaveLoopOutput((th_buf,), (d_buf,), n, waves, fill.clamp(max=self.capacity),
                              max_waves)

    def carry_of(self, out: WaveLoopOutput):
        return [out.theta_segments[0]], [out.dist_segments[0]], [out.fill_counts], \
            out.n_accepted

    def read(self, out: WaveLoopOutput):
        """(waves done, accepted, every shard's valid rows) in one host sync;
        the waves and the total are the same on every rank."""
        waves, n, *fills = sync_counts(out.waves_done, out.n_accepted,
                                       *(f.to(self.device) for f in
                                         gather(out.fill_counts, self.group)))
        self.sim.record_gated("wave", self.cfg.batch_size // self.n_shards,
                              out.enqueued - waves)
        return waves, n, tuple(fills)

    def harvest(self, out: WaveLoopOutput, state, fill) -> None:
        """Every shard's valid rows, gathered in shard order."""
        top = max(fill)
        state.accepted_theta, state.accepted_dist = [], []
        if not top:
            return
        ths = gather(out.theta_segments[0][:top], self.group)
        ds = gather(out.dist_segments[0][:top], self.group)
        for th, d, c in zip(ths, ds, fill):
            if c:
                state.accepted_theta.append(th[:c].cpu().numpy())
                state.accepted_dist.append(d[:c].cpu().numpy())

    def segments(self, out: WaveLoopOutput):
        """`repro`'s layout of every shard's buffers, gathered on every rank."""
        cap = self.capacity
        return (torch.cat(gather(out.theta_segments[0][:cap], self.group)).cpu().numpy(),
                torch.cat(gather(out.dist_segments[0][:cap], self.group)).cpu().numpy(),
                torch.cat(gather(out.fill_counts, self.group)).cpu().numpy())


def make_shardmap_wave_runner(group, prior: UniformBoxPrior, simulator: SimulatorFn,
                              cfg: ABCConfig) -> ShardedWaveRunner:
    """The per-rank replica of the device wave loop: `cfg.batch_size` is the
    global batch, `B / n` rows a rank a wave, a segment of
    `wave_capacity(cfg, B / n)` rows (a shard can take up to target - 1 of
    the global accepts plus its own last wave)."""
    n, shard = _shards_of(group, cfg)
    return ShardedWaveRunner(sim=simulator, prior=prior, cfg=cfg,
                             capacity=wave_capacity(cfg, cfg.batch_size // n),
                             n_params=prior.dim, group=group, shard=shard, n_shards=n)


# --------------------------------------------------------------------------
# The pjit style: one logical wave, rank r its rows [r·B/n, (r+1)·B/n)
# --------------------------------------------------------------------------

def make_pjit_runner(group, prior: UniformBoxPrior, simulator: SimulatorFn,
                     cfg: ABCConfig) -> Callable[[int, int], RunOutput]:
    """One logical wave of `cfg.batch_size` a call, from the wave's own
    (prior seed, simulation seed): this rank draws its rows at offset
    r·B/n. Under outfeed every rank's chunks are gathered in rank order, so
    the output is `core.abc.abc_run_batch`'s chunk for chunk, with the
    global accepted count (`RunOutput.accept_count`); `chunk_size` must
    divide B / n. Under topk it is the k lowest distances of the whole
    wave, ties to the lower row of the wave, the same on every rank."""
    n, shard = _shards_of(group, cfg)
    b = cfg.batch_size // n
    if cfg.strategy == "outfeed" and b % cfg.chunk_size:
        raise ValueError(f"chunk_size {cfg.chunk_size} does not divide the {b} rows of a "
                         f"rank (batch_size {cfg.batch_size} over {n} ranks)")
    p, dev, offset = prior.dim, simulator.device, shard * b

    def run(prior_seed: int, sim_seed: int) -> RunOutput:
        theta, d = simulator.wave(prior, prior_seed, sim_seed, b, offset=offset)
        count = (d <= cfg.tolerance).sum(dtype=torch.int64).reshape(1)
        dist.all_reduce(count, group=group)
        if cfg.strategy == "outfeed":
            nc, cs = b // cfg.chunk_size, cfg.chunk_size
            th_c, d_c = theta.reshape(nc, cs, p), d.reshape(nc, cs)
            flags = (d_c <= cfg.tolerance).any(dim=1)
            return RunOutput(*(torch.cat(gather(x, group)).to(dev)
                               for x in (th_c, d_c, flags)), count)
        # each rank's k lowest by (distance, row), then the wave's k lowest
        idx = torch.argsort(d, stable=True)[:min(cfg.top_k, b)]
        th_k, d_k, rows = (torch.cat(gather(x, group)).to(dev)
                           for x in (theta[idx], d[idx], idx + offset))
        order = torch.argsort(rows)
        order = order[torch.argsort(d_k[order], stable=True)][:cfg.top_k]
        return RunOutput(th_k[order], d_k[order],
                         torch.zeros((0,), dtype=torch.bool, device=dev), count)

    return run


@dataclasses.dataclass
class PjitWaveRunner(WaveRunner):
    """The device wave loop of one logical wave over `group`: every rank
    keeps the single-device state (one segment of `wave_capacity(cfg)` rows,
    `fill_counts` of shape [1]) and draws rows [r·B/n, (r+1)·B/n) of each
    wave. A wave's accepted rows of rank r land at the single-device
    positions fill + (the accepts of ranks 0..r-1) + their order on rank r:
    the rank keeps them in a local buffer during the segment, and `read`
    gathers every rank's and places them by those positions, so the
    segment, the fill and the posterior are the unsharded run's bitwise.
    `read` must come before `carry_of`, `harvest` and `segments`."""

    group: object = None
    shard: int = 0
    n_shards: int = 1

    def __call__(self, seed: int, run_idx0: int, carry, max_waves: int) -> WaveLoopOutput:
        """Enqueue waves run_idx0 .. run_idx0 + max_waves - 1 of `seed`: each
        reads the global gate `accepted < target`, draws this rank's rows at
        its offset with the wave's own seeds and all-reduces the n ranks'
        counts (the one collective a wave). Nothing here waits for the
        device."""
        (th_buf,), (d_buf,), (fill,), _ = carry
        cfg, dev, cap, n = self.cfg, self.device, self.capacity, self.n_shards
        batch = cfg.batch_size // n
        offset = self.shard * batch
        tol = tolerance32(cfg.tolerance)
        theta = torch.empty((batch, self.n_params), dtype=torch.float32, device=dev)
        dist_ = torch.empty((batch,), dtype=torch.float32, device=dev)
        # this rank's accepted rows of the segment in stream order, and every
        # rank's accepted count of each wave
        loc_th = torch.empty((cap + 1, self.n_params), dtype=torch.float32, device=dev)
        loc_d = torch.empty((cap + 1,), dtype=torch.float32, device=dev)
        loc_fill = torch.zeros((1,), dtype=torch.int64, device=dev)
        hist = torch.zeros((max_waves, n), dtype=torch.int64, device=dev)
        me = torch.full((1,), self.shard, dtype=torch.int64, device=dev)
        fill0 = fill
        waves = torch.zeros((1,), dtype=torch.int64, device=dev)
        for i in range(max_waves):
            with span("abc.wave"):
                active = fill < cfg.target_accepted
                self.sim.wave(self.prior, *wave_seeds(seed, run_idx0 + i), batch,
                              gate=active.to(torch.int32), out=(theta, dist_), offset=offset)
                accept = (dist_ <= tol) & active
                loc_th, loc_d, new_fill = compact_accepted(loc_th, loc_d, loc_fill, theta,
                                                           dist_, accept, cap)
                counts = torch.zeros((n,), dtype=torch.int64, device=dev)
                counts.index_copy_(0, me, new_fill - loc_fill)
                dist.all_reduce(counts, group=self.group)  # the one collective a wave
                hist[i] = counts
                loc_fill = new_fill
                fill = fill + counts.sum(0, keepdim=True)
                waves += active
        return WaveLoopOutput((th_buf,), (d_buf,), fill, waves, fill.clamp(max=cap),
                              max_waves, pending=[loc_th, loc_d, hist, fill0])

    def read(self, out: WaveLoopOutput):
        """(waves done, accepted, valid rows) in one host sync, then every
        rank's rows of the segment gathered and placed at their
        single-device positions; the same on every rank."""
        loc_th, loc_d, hist, fill0 = out.pending
        waves, n, fill, *local = sync_counts(out.waves_done, out.n_accepted, out.fill_counts,
                                             hist.sum(0))
        self.sim.record_gated("wave", self.cfg.batch_size // self.n_shards,
                              out.enqueued - waves)
        top = min(max(local), self.capacity)
        if top:
            self._place(out, loc_th[:top], loc_d[:top], hist, fill0, local)
        out.pending.clear()
        return waves, n, fill

    def _place(self, out: WaveLoopOutput, loc_th, loc_d, hist, fill0, local) -> None:
        """Rank s's row j of the segment, from wave w, goes to (the fill
        before w) + (the accepts of ranks 0..s-1 in w) + (j less rank s's
        rows before w); rows at or past the capacity, and the rows a rank
        does not hold, go to the spare row."""
        dev, cap = self.device, self.capacity
        totals = hist.sum(1)
        wave_start = fill0 + torch.cumsum(totals, 0) - totals  # [waves]
        ranks_before = torch.cumsum(hist, 1) - hist  # [waves, n]
        ends = torch.cumsum(hist, 0)  # [waves, n]: a rank's rows up to each wave
        j = torch.arange(loc_d.shape[0], device=dev)
        ths, ds = gather(loc_th, self.group), gather(loc_d, self.group)
        th_buf, d_buf = out.theta_segments[0], out.dist_segments[0]
        for s, rows in enumerate(local):
            if not rows:
                continue
            w = torch.searchsorted(ends[:, s].contiguous(), j, right=True).clamp_(
                max=hist.shape[0] - 1)
            pos = wave_start[w] + ranks_before[w, s] + j - (ends[w, s] - hist[w, s])
            pos = torch.where(j < rows, pos, cap).clamp_(max=cap)
            th_buf.index_copy_(0, pos, ths[s].to(dev))
            d_buf.index_copy_(0, pos, ds[s].to(dev))

    def _check_read(self, out: WaveLoopOutput) -> None:
        if out.pending:
            raise RuntimeError("read() this output first: it places the ranks' rows")

    def carry_of(self, out: WaveLoopOutput):
        self._check_read(out)
        return super().carry_of(out)

    def harvest(self, out: WaveLoopOutput, state, fill) -> None:
        self._check_read(out)
        super().harvest(out, state, fill)

    def segments(self, out: WaveLoopOutput):
        self._check_read(out)
        return super().segments(out)


def make_pjit_wave_runner(group, prior: UniformBoxPrior, simulator: SimulatorFn,
                          cfg: ABCConfig) -> PjitWaveRunner:
    """The pjit device loop: B / n rows a rank a wave at offset r·B/n, the
    single-device buffers (`wave_capacity(cfg)` rows) on every rank."""
    n, shard = _shards_of(group, cfg)
    return PjitWaveRunner(sim=simulator, prior=prior, cfg=cfg, capacity=wave_capacity(cfg),
                          n_params=prior.dim, group=group, shard=shard, n_shards=n)


# --------------------------------------------------------------------------
# A local launcher
# --------------------------------------------------------------------------

def _rank_main(rank, fn, nprocs, store, backend, device, out_dir, args):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    kw = {}
    if torch.device(device).type == "cuda":
        dev = rank_device(device)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=nprocs, **kw)
    try:
        result = fn(rank, nprocs, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # atomic: a rank that dies while writing leaves no truncated result
    with atomic_write(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, nprocs: int, *args, device="cpu", backend: Optional[str] = None,
                timeout: float = 120.0, tmp_dir: Optional[str] = None) -> list:
    """Run `fn(rank, nprocs, *args)` in `nprocs` processes of this host,
    joined in one process group over a `file://` store under `tmp_dir` (the
    backend follows `device` unless given; "cuda" gives rank r
    `cuda:r`); returns each rank's result, in rank order. A rank that raises
    fails the call with its traceback; if the ranks have not finished within
    `timeout` seconds every one is killed and the call raises."""
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="ranks_", dir=tmp_dir)
    try:
        ctx = mp.spawn(_rank_main, nprocs=nprocs, join=False,
                       args=(fn, nprocs, os.path.join(work, "store"),
                             backend or backend_for(device), str(device), work, args))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(nprocs):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)

