"""The scaling study of the paper's 16-IPU experiment (§4.5) on
`torch.distributed` (port of `repro.core.scaling`).

The paper's systems claim is that the ABC framework "scales across 16 IPUs,
with scaling overhead not exceeding 8%". This module runs that experiment on
the ranks of a process group (`core.distributed`'s execution model: a rank a
shard, NCCL on cards, gloo on the CPU):

  * `device_mesh(n)` is the subgroup of the first `n` ranks, so one launch
    measures every device count of the curve (the n=1 cell and the n=8 cell
    share rank 0, as the paper sweeps 1..16 IPUs on one machine); every rank
    calls it, and ranks outside a cell's subgroup wait at a barrier;
  * `run_scaling_cell` times the sharded device wave loop
    (`distributed.make_wave_runner`, of `ScalingConfig.style`: "shard_map"
    or "pjit") over a fixed wave budget with an unreachable acceptance
    target, so every device count does the same work a rank and the
    measured difference is the scaling overhead (the counts' all-reduce a
    wave and the gather of the accepted rows a segment);
  * `run_scaling_study` sweeps (model, backend) x device count under weak
    scaling (global batch = n x batch_per_device, the paper's "2x100k means
    100k per IPU") and derives, a cell,

        parallel_efficiency  = sims_per_s(n) / (n * sims_per_s(n_ref))
        scaling_overhead_pct = (1 - parallel_efficiency) * 100

    Rank 0 returns the report (`repro`'s keys and fields), the others None.

Correctness: `make_reference_wave_runner` runs the N-shard program in one
process, lockstep: each wave reads the gate once from the global count,
then each shard runs its sub-batch with its own seeds
(`core.abc.shard_seeds`) into its own segment, then the counts are summed.
An N-rank run of `distributed.make_wave_runner` is bitwise this reference,
segment for segment (tests/test_torch_distributed.py), and one shard is the
unsharded `run_abc`. The reference runs on the CPU and on one card, and the
campaign's device groups run it with shard s on the group's s-th device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.core.abc import (
    ABCConfig,
    SimulatorFn,
    WaveRunner,
    calibrate_tolerance,
    run_abc,
    wave_capacity,
)
from repro_torch.core.priors import UniformBoxPrior
from repro_torch.epi.data import get_dataset

#: the port's backends: the fused CUDA kernel (its plain version on the CPU)
BACKENDS = ("cuda",)


def device_mesh(n: int, group=None):
    """The subgroup of the first `n` ranks of `group` (the default group when
    None), made by `new_group`, which every rank must call in the same
    order. A rank outside it gets `GroupMember.NON_GROUP_MEMBER`."""
    world = dist.get_world_size(group)
    if n > world:
        raise ValueError(
            f"requested {n} devices but only {world} ranks are running; launch "
            f"more with torchrun --nproc-per-node={n} (one rank a card, or "
            "--device cpu for gloo ranks on the CPU)"
        )
    if n == world:
        return group or dist.group.WORLD
    return dist.new_group(dist.get_process_group_ranks(group or dist.group.WORLD)[:n])


def make_reference_wave_runner(prior: UniformBoxPrior, simulator, cfg: ABCConfig,
                               n_shards: int) -> WaveRunner:
    """The N-shard wave loop run lockstep in one process: every shard on
    `simulator`, or shard s on `simulator[s]` when a sequence of `n_shards`
    simulators is given (the campaign's device groups). Its segments,
    fills, totals and wave counts are bitwise those of an N-rank
    `distributed.make_wave_runner` with the same seed."""
    if cfg.batch_size % n_shards:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by {n_shards} shards")
    sims: Tuple[SimulatorFn, ...] = (tuple(simulator) if isinstance(simulator, (list, tuple))
                                     else (simulator,) * n_shards)
    if len(sims) != n_shards:
        raise ValueError(f"{len(sims)} simulators for {n_shards} shards")
    return WaveRunner(sim=sims[0], prior=prior, cfg=cfg,
                      capacity=wave_capacity(cfg, cfg.batch_size // n_shards),
                      n_params=prior.dim, shard_sims=sims if n_shards > 1 else ())


# --------------------------------------------------------------------------
# The study
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScalingConfig:
    """One scaling study: (model, backend) x device-count grid, weak scaling.
    `repro`'s fields and defaults, less its JAX-only knobs (`tile`,
    `scan_unroll`) and with the port's backend, plus the CUDA `block`."""

    device_counts: Tuple[int, ...] = (1, 2, 4, 8)
    models: Tuple[str, ...] = ("siard",)
    backends: Tuple[str, ...] = BACKENDS
    #: batch a device; the global batch of the n-device cell is n * this
    batch_per_device: int = 4096
    #: fixed wave budget a measurement (the target is unreachable)
    waves: int = 8
    num_days: int = 20
    dataset: str = "synthetic_small"
    #: timed repetitions a cell, best-of (a warm-up run first)
    reps: int = 3
    #: pilot quantile of the epsilon, so that every cell accepts and
    #: gathers as real runs do
    tolerance_quantile: float = 0.01
    style: str = "shard_map"
    #: CUDA block size in threads; None for the kernel's own default
    block: Optional[int] = None
    #: take each cell's block from the measured tuning cache (`core.tuning`,
    #: keyed by the batch of a rank's launches, batch_per_device); an
    #: explicit `block` wins
    autotune: bool = False

    def __post_init__(self):
        if not self.device_counts:
            raise ValueError("device_counts must be non-empty")
        if self.style not in ("shard_map", "pjit"):
            raise ValueError(f"unknown runner style {self.style!r}")
        bad = [b for b in self.backends if b not in BACKENDS]
        if bad:
            raise ValueError(f"unknown backends {bad}; the port's scaling study runs "
                             f"{BACKENDS}")


def cell_key(model: str, backend: str, batch_per_device: int, n: int) -> str:
    return f"{model}/{backend}/b{batch_per_device}/n{n}"


def _cell_abc_config(scfg: ScalingConfig, model: str, backend: str,
                     n: int, tolerance: float) -> ABCConfig:
    global_batch = n * scfg.batch_per_device
    return ABCConfig(
        batch_size=global_batch,
        tolerance=tolerance,
        # unreachable: every cell runs the full wave budget
        target_accepted=scfg.waves * global_batch + 1,
        strategy="outfeed",
        chunk_size=global_batch,
        max_runs=scfg.waves,
        num_days=scfg.num_days,
        backend=backend,
        model=model,
        wave_loop="device",
        block=scfg.block,
        autotune=scfg.autotune,
    )


def run_scaling_cell(dataset, cfg: ABCConfig, group, reps: int = 3,
                     style: str = "shard_map", seed: int = 1,
                     device="cuda") -> Dict[str, float]:
    """Time the sharded device wave loop of one cell on `group`'s ranks:
    best of `reps` walls after a warm-up run (seed 0), with the throughput
    and the accept statistics (the same on every rank)."""
    from repro_torch.core import distributed

    runner = distributed.make_wave_runner(group, dataset, cfg, style=style, device=device)
    run_abc(dataset, cfg, seed=0, wave_runner=runner)  # warm-up: first launches
    best, post = None, None
    for _ in range(max(1, reps)):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        post = run_abc(dataset, cfg, seed=seed, wave_runner=runner)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return {
        "wall_s": best,
        "simulations": int(post.simulations),
        "sims_per_s": post.simulations / best,
        "waves": int(post.runs),
        "n_accepted": int(len(post)),
        "accept_rate": len(post) / max(post.simulations, 1),
    }


def run_scaling_study(scfg: ScalingConfig, group=None, verbose: bool = False,
                      device="cuda") -> Optional[Dict]:
    """Sweep the (model, backend) x device-count grid over the first ranks
    of `group` (the default group, formed by `distributed.process_group`
    when there is none). Every rank calls it; rank 0 returns the report,
    the others None.

    Efficiency is relative to the smallest device count of the sweep:
    `parallel_efficiency = tp_n * n_ref / (tp_ref * n)` under weak scaling,
    `scaling_overhead_pct = (1 - efficiency) * 100`, the number the paper
    bounds by 8% at 16 IPUs. Ranks that share one card, or gloo ranks on
    one CPU, measure dispatch and collective overhead only."""
    from repro_torch.core import distributed

    dev = distributed.rank_device(device)
    group = distributed.process_group(group, dev)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    counts = sorted(set(scfg.device_counts))
    meshes = {n: device_mesh(n, group) for n in counts}  # every rank, in order
    n_ref = counts[0]
    report: Dict = {
        "config": dataclasses.asdict(scfg),
        "n_visible_devices": world,
        "device_kind": dev.type,
        "reference_device_count": n_ref,
        "cells": {},
    }
    for model in scfg.models:
        ds = get_dataset(scfg.dataset, num_days=scfg.num_days, model=model)
        for backend in scfg.backends:
            # one epsilon a (model, backend), calibrated at the batch a
            # device so that every device count accepts at one rate
            cal_cfg = ABCConfig(
                batch_size=scfg.batch_per_device, tolerance=1.0,
                chunk_size=scfg.batch_per_device, num_days=scfg.num_days,
                backend=backend, model=model, block=scfg.block,
            )
            tol = calibrate_tolerance(ds, cal_cfg, seed=42, quantile=scfg.tolerance_quantile,
                                      n_pilot=scfg.batch_per_device, device=dev)
            ref_tp = None
            for n in counts:
                cfg = _cell_abc_config(scfg, model, backend, n, tol)
                cell = None
                if rank < n:
                    cell = run_scaling_cell(ds, cfg, meshes[n], reps=scfg.reps,
                                            style=scfg.style, device=dev)
                dist.barrier(group=group)  # ranks outside the cell wait here
                if rank != 0:
                    continue
                if n == n_ref:
                    ref_tp = cell["sims_per_s"]
                eff = cell["sims_per_s"] * n_ref / (ref_tp * n)
                cell.update({
                    "model": model, "backend": backend, "devices": n,
                    "batch_per_device": scfg.batch_per_device,
                    "global_batch": n * scfg.batch_per_device,
                    "tolerance": tol,
                    "parallel_efficiency": eff,
                    "scaling_overhead_pct": (1.0 - eff) * 100.0,
                })
                report["cells"][cell_key(model, backend, scfg.batch_per_device, n)] = cell
                if verbose:
                    print(f"[scaling] {model}/{backend} n={n}: "
                          f"{cell['sims_per_s']:,.0f} sims/s, eff={eff:.3f}, "
                          f"overhead={cell['scaling_overhead_pct']:.1f}%")
    return report if rank == 0 else None


def format_report(report: Dict) -> str:
    """The throughput-against-device-count curves as a table."""
    headers = ["model", "backend", "devices", "global_batch", "wall_ms",
               "sims/s", "efficiency", "overhead_%"]
    rows: List[List[str]] = []
    for cell in report["cells"].values():
        rows.append([
            cell["model"], cell["backend"], str(cell["devices"]),
            str(cell["global_batch"]), f"{cell['wall_s'] * 1e3:.1f}",
            f"{cell['sims_per_s']:,.0f}",
            f"{cell['parallel_efficiency']:.3f}",
            f"{cell['scaling_overhead_pct']:.1f}",
        ])
    widths = [max(len(h), max((len(r[i]) for r in rows), default=0))
              for i, h in enumerate(headers)]

    def fmt(row):
        return " | ".join(c.rjust(w) for c, w in zip(row, widths))

    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])

