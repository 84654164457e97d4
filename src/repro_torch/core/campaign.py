"""Multi-scenario ABC campaigns: the paper's §5 study in one process (port
of `repro.core.campaign`).

A campaign runs a grid of scenarios (dataset x model x backend x seed x
intervention x summary) through the device wave loop (`core.abc.WaveRunner`)
and writes one report:

  * each scenario is the same inference, bitwise, as a solo run with its
    seed: `calibrate_tolerance(dataset, cfg, seed=seed,
    quantile=auto_quantile, n_pilot=pilot_size)` for its tolerance, then
    `run_abc` on the device loop. Segments end earlier here (at multiples of
    `checkpoint_every`) but waves past the target are gated off, so the
    accepted rows, runs and simulations do not move;
  * scenarios of one shape (model, days, batch, backend, schedule shape,
    summary, distance) share one entry of the shape cache. The kernel reads
    the series, the dataset's scalars, the schedule's breakpoints and scales
    and the prior box at run time, so a new country or lockdown day only
    packs its series into a simulator (`ops.make_abc_sim`); scenarios of one
    dataset and schedule share it, and a regional entry shares its mobility
    buffer. The libraries are built once a process, at their first launch
    (`kernels.build`);
  * scenarios go round-robin over the cards (or all on the CPU) and advance
    in rounds: each round enqueues one segment of every active scenario,
    then reads and finishes them in order (one host sync a segment). With
    `devices_per_scenario` k > 1 the devices are carved into disjoint groups
    of k (a device list may name one device more than once, as in
    `["cuda:0"] * 4` or `["cpu"] * 4`), scenarios go round-robin over the
    groups, and each runs the lockstep reference of k shards
    (`core.scaling.make_reference_wave_runner`), shard s on its group's s-th
    device: a cell is bitwise its solo run with that runner, and its
    report's `device` names the group's positions ("0+1", "2+3", ...);
  * each scenario checkpoints through `repro_torch.checkpoint`, in
    `repro`'s layout and metadata, at `repro`'s cadence: at a segment end
    that reaches a multiple of `checkpoint_every`, and when it finishes
    (with 0, only then). It resumes from its newest checkpoint: a finished
    one replays its recorded result and launches nothing.

    from repro_torch.core.campaign import CampaignConfig, run_campaign
    report = run_campaign(CampaignConfig(
        datasets=("italy", "new_zealand", "usa"), models=("siard", "seiard")))

CLI: `python -m repro_torch.launch.abc_run --campaign ...`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.abc import (
    SEGMENT_WAVES,
    ABCConfig,
    ABCState,
    SimulatorFn,
    calibrate_tolerance,
    make_simulator,
    run_param_names,
    wave_capacity,
)
from repro_torch.core.priors import schedule_prior
from repro_torch.core.scaling import BACKENDS, make_reference_wave_runner
from repro_torch.core.summaries import get_summary
from repro_torch.device import resolve_device
from repro_torch.epi.data import CountryData, get_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule
from repro_torch.ioutils import atomic_write_text


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the campaign grid. `model` is a registry name or a spec
    (e.g. `regionalize(get_model("seir"), 100, "ring:0.1")`); a spec tags
    the scenario and its checkpoint directory by its name."""

    dataset: str
    model: object  # registry name (str) or CompartmentalModel spec
    backend: str = "cuda"
    seed: int = 0
    #: intervention schedule; cells whose schedules share a shape share a
    #: shape-cache entry
    schedule: Optional[InterventionSchedule] = None
    #: SummarySpec, registry name, or None for the raw daily series
    summary: Optional[object] = None
    #: distance kind; part of the name, so cells that differ only in it
    #: never share a checkpoint directory
    distance: str = "euclidean"

    @property
    def model_tag(self) -> str:
        """Filesystem/JSON-safe model label (spec objects tag by name)."""
        return self.model if isinstance(self.model, str) else self.model.name

    @property
    def name(self) -> str:
        base = f"{self.dataset}__{self.model_tag}__{self.backend}__s{self.seed}"
        if self.schedule is not None and not self.schedule.is_empty:
            base += f"__{self.schedule.tag()}"
        spec = get_summary(self.summary)
        if not spec.is_identity:
            base += f"__{spec.tag()}"
        if self.distance != "euclidean":
            base += f"__{self.distance}"
        return base


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Grid, per-scenario ABC settings and campaign policy: `repro`'s
    fields less its JAX-only knobs (`interpret`, `tile`, `scan_unroll`),
    plus the CUDA `block`."""

    datasets: Tuple[str, ...]
    #: registry names and/or spec objects
    models: Tuple[object, ...] = ("siard",)
    backends: Tuple[str, ...] = BACKENDS
    seeds: Tuple[int, ...] = (0,)
    #: InterventionSchedule or None (the constant-theta cell)
    interventions: Tuple[Optional[InterventionSchedule], ...] = (None,)
    #: SummarySpec instances or registry names; None is the raw series
    summaries: Tuple[Optional[object], ...] = (None,)
    #: distance kind of every cell
    distance: str = "euclidean"
    # the ABC shape of every cell; the tolerance is per scenario
    batch_size: int = 8192
    num_days: int = 49
    target_accepted: int = 100
    max_runs: int = 10_000
    #: one epsilon for every scenario; None calibrates each from its pilot
    tolerance: Optional[float] = None
    #: pilot quantile of the calibration (the expected acceptance rate)
    auto_quantile: float = 1e-3
    pilot_size: int = 8192
    out_dir: str = "experiments/campaigns/default"
    #: a segment never crosses a multiple of this many waves, and a scenario
    #: checkpoints at each multiple and when it finishes (0: only when it
    #: finishes; segments of SEGMENT_WAVES)
    checkpoint_every: int = 32
    keep_checkpoints: int = 2
    #: cells whose model does not observe the dataset's channels are
    #: recorded as "skipped" instead of failing the campaign
    skip_incompatible: bool = True
    #: devices a scenario: 1 places one scenario a device; k > 1 carves the
    #: devices into disjoint groups of k and shards each scenario's waves
    #: over its group (`make_reference_wave_runner`, shard s on the group's
    #: s-th device); the sample stream is a solo k-shard run's
    devices_per_scenario: int = 1
    #: CUDA block size in threads; None for the kernel's own default
    block: Optional[int] = None
    #: take the block of each shape from the measured tuning cache
    #: (`core.tuning`), tuned against the first dataset that reaches the
    #: shape; an explicit `block` wins
    autotune: bool = False

    def __post_init__(self):
        if self.devices_per_scenario < 1:
            raise ValueError("devices_per_scenario must be >= 1")
        bad = [b for b in self.backends if b not in BACKENDS]
        if bad:
            raise ValueError(f"unknown backends {bad}; the port's campaign runs {BACKENDS}")

    def scenarios(self) -> List[Scenario]:
        return [
            Scenario(dataset=d, model=m, backend=b, seed=s, schedule=iv,
                     summary=su, distance=self.distance)
            for d in self.datasets
            for m in self.models
            for b in self.backends
            for s in self.seeds
            for iv in self.interventions
            for su in self.summaries
        ]

    def abc_config(self, sc: Scenario, tolerance: float) -> ABCConfig:
        return ABCConfig(
            batch_size=self.batch_size,
            tolerance=tolerance,
            target_accepted=self.target_accepted,
            strategy="outfeed",
            chunk_size=self.batch_size,
            max_runs=self.max_runs,
            num_days=self.num_days,
            backend=sc.backend,
            model=sc.model,
            wave_loop="device",
            schedule=sc.schedule,
            summary=sc.summary,
            distance=sc.distance,
            block=self.block,
            autotune=self.autotune,
        )


@dataclasses.dataclass
class ScenarioResult:
    name: str
    dataset: str
    model: str
    backend: str
    seed: int
    status: str  # "ok" | "budget_exhausted" | "skipped" | "resumed_complete"
    tolerance: Optional[float] = None  # None until calibrated (skipped cells)
    eps_schedule: Tuple[float, ...] = ()
    n_accepted: int = 0
    runs: int = 0
    simulations: int = 0
    acceptance_rate: float = 0.0
    wall_time_s: float = 0.0
    posterior_mean: Dict[str, float] = dataclasses.field(default_factory=dict)
    posterior_std: Dict[str, float] = dataclasses.field(default_factory=dict)
    checkpoint_dir: str = ""
    device: str = ""
    detail: str = ""


def _jsonable(obj):
    """Strict-JSON sanitizer: numpy scalars -> python, NaN/inf -> None."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else None
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


def schedule_shape_key(schedule: Optional[InterventionSchedule]) -> tuple:
    """The shape of an intervention schedule: () for None or an empty one,
    else (n_windows, tv_params). Breakpoint days and scale values are
    run-time values of the kernel, so schedules of one key share a
    shape-cache entry."""
    if schedule is None or schedule.is_empty:
        return ()
    return (schedule.n_windows, schedule.tv_params)


@dataclasses.dataclass
class CampaignReport:
    """What a campaign did; saved as one strict-JSON file."""

    config: Dict
    scenarios: List[ScenarioResult]
    wall_time_s: float = 0.0
    compiled_shapes: int = 0

    def save(self, path: str | Path) -> Path:
        payload = {
            "config": self.config,
            "wall_time_s": self.wall_time_s,
            "compiled_shapes": self.compiled_shapes,
            "scenarios": [dataclasses.asdict(r) for r in self.scenarios],
        }
        # allow_nan=False keeps the file strict JSON
        return atomic_write_text(path, json.dumps(_jsonable(payload), indent=1,
                                                  allow_nan=False))

    def summary_table(self) -> str:
        headers = ["scenario", "status", "eps", "accepted", "runs", "acc_rate", "wall_s"]
        rows = [[r.name, r.status, "-" if r.tolerance is None else f"{r.tolerance:.3g}",
                 str(r.n_accepted), str(r.runs), f"{r.acceptance_rate:.2e}",
                 f"{r.wall_time_s:.1f}"] for r in self.scenarios]
        widths = [max(len(h), max((len(row[i]) for row in rows), default=0))
                  for i, h in enumerate(headers)]

        def fmt(row):
            return " | ".join(c.ljust(w) for c, w in zip(row, widths))

        lines = [fmt(headers), "-+-".join("-" * w for w in widths)]
        lines += [fmt(r) for r in rows]
        ok = sum(1 for r in self.scenarios if r.status in ("ok", "resumed_complete"))
        lines.append(f"{ok}/{len(self.scenarios)} scenarios complete, "
                     f"{self.compiled_shapes} compiled shapes, "
                     f"wall {self.wall_time_s:.1f}s")
        return "\n".join(lines)


class _ShapeCache:
    """One entry a scenario shape, holding the simulators made under it,
    one a (dataset, schedule, device). The dataset is not part of the key:
    the kernel reads the series and its scalars at run time. Under
    `autotune` the entry's block is resolved once, against the first
    dataset that reaches the shape: the block is a property of the shape."""

    def __init__(self, cfg: CampaignConfig):
        self.cfg = cfg
        self._entries: Dict[tuple, Dict[tuple, SimulatorFn]] = {}
        self._blocks: Dict[tuple, Optional[int]] = {}

    @property
    def n_compiled(self) -> int:
        return len(self._entries)

    def key_of(self, sc: Scenario) -> tuple:
        # the resolved spec carries the region axis, so a 100-region spec
        # never aliases its one-region namesake
        return ((get_model(sc.model), self.cfg.num_days, self.cfg.batch_size, sc.backend)
                + schedule_shape_key(sc.schedule) + (get_summary(sc.summary), sc.distance))

    def simulator(self, sc: Scenario, dataset: CountryData, device) -> SimulatorFn:
        sims = self._entries.setdefault(self.key_of(sc), {})
        key = (dataset.name, sc.schedule, device)
        if key not in sims:
            # a regional entry shares its mobility buffer on each device
            mob = next((s.mob for (_, _, d), s in sims.items()
                        if d == device and getattr(s, "mob", None) is not None), None)
            sims[key] = make_simulator(dataset, self.shape_config(sc, dataset, device), device,
                                       mob=mob)
        return sims[key]

    def shape_config(self, sc: Scenario, dataset: CountryData, device) -> ABCConfig:
        """The scenario's config for its simulators: under autotune the
        shape's tuned block, with autotune off."""
        cfg = self.cfg.abc_config(sc, 1.0)
        if not cfg.autotune:
            return cfg
        key = self.key_of(sc)
        if key not in self._blocks:
            from repro_torch.core import tuning

            self._blocks[key] = tuning.resolve_tuned(dataset, cfg, device=device).block
        return dataclasses.replace(cfg, autotune=False, block=self._blocks[key])


class _ScenarioRun:
    """One scenario's state: its wave runner and carry, its checkpoints and
    its result."""

    def __init__(self, sc: Scenario, cfg: CampaignConfig, cache: _ShapeCache,
                 group, verbose: bool = False):
        """`group`: one device, or the scenario's group as (position in the
        campaign's device list, device) pairs."""
        self.sc, self.cfg, self.verbose = sc, cfg, verbose
        if isinstance(group, torch.device):
            group = [(0, group)]
        label = (str(group[0][1]) if len(group) == 1
                 else "+".join(str(i) for i, _ in group))
        self.result = ScenarioResult(name=sc.name, dataset=sc.dataset, model=sc.model_tag,
                                     backend=sc.backend, seed=sc.seed, status="pending",
                                     device=label)
        self.done = False
        self.ckpt = None
        self._out = None
        self._t0 = time.time()
        try:
            self.dataset = get_dataset(sc.dataset, num_days=cfg.num_days, model=sc.model)
        except ValueError as e:
            # a model that does not observe the dataset's channels
            if not cfg.skip_incompatible:
                raise
            self.result.status = "skipped"
            self.result.detail = str(e)
            self.done = True
            return
        shape_cfg = cfg.abc_config(sc, tolerance=1.0)
        self.prior = schedule_prior(get_model(sc.model), sc.schedule)
        sims = [cache.simulator(sc, self.dataset, d) for _, d in group]
        self.sim, self.shards = sims[0], len(sims)
        self.capacity = wave_capacity(shape_cfg, cfg.batch_size // self.shards)
        ckpt_dir = Path(cfg.out_dir) / "checkpoints" / sc.name
        self.ckpt = Checkpointer(ckpt_dir, keep=cfg.keep_checkpoints)
        self.result.checkpoint_dir = str(ckpt_dir)
        self.state = ABCState(n_params=self.prior.dim)
        self.eps_schedule: List[float] = []
        restored_eps = self._try_restore()
        if self.done:
            return  # a finished scenario, replayed from its checkpoint
        if restored_eps is not None:
            eps = restored_eps
        elif cfg.tolerance is not None:
            eps = float(cfg.tolerance)
        else:
            eps = calibrate_tolerance(self.dataset, shape_cfg, seed=sc.seed,
                                      quantile=cfg.auto_quantile, n_pilot=cfg.pilot_size,
                                      prior=self.prior, simulator=self.sim)
        if not self.eps_schedule:
            self.eps_schedule = [eps]
        self.abc_cfg = cfg.abc_config(sc, tolerance=eps)
        self.result.tolerance = eps
        self.result.eps_schedule = tuple(self.eps_schedule)
        self.runner = make_reference_wave_runner(self.prior, sims, self.abc_cfg, self.shards)
        self.carry = self.runner.init(self.state)

    # ------------------------------------------------------------- restore
    def _try_restore(self) -> Optional[float]:
        """Load the newest checkpoint, if any. Returns its epsilon (resume)
        or None (fresh start); sets `done` for a finished scenario. A
        checkpoint of another buffer layout restarts the scenario with a
        message; every other error raises. The segments' rows go to the
        state in shard order, and `WaveRunner.init` splits them again, as
        `repro` does."""
        if not self.ckpt.steps():
            return None
        rows = self.shards * self.capacity
        like = {"theta_buf": np.zeros((rows, self.prior.dim), np.float32),
                "dist_buf": np.zeros((rows,), np.float32)}
        try:
            tree, meta, _ = self.ckpt.restore(like)
        except ValueError as e:
            if "shape mismatch" not in str(e):
                raise
            print(f"[campaign] {self.sc.name}: checkpoint layout does not match this "
                  f"campaign's buffers, restarting ({e})")
            return None
        self.state.run_idx = int(meta["run_idx"])
        self.state.simulations = int(meta["simulations"])
        # per-shard segment fills (a checkpoint without them holds one total)
        for s, c in enumerate(int(c) for c in meta.get("fills", [meta["fill"]])):
            if c:
                lo = s * self.capacity
                self.state.accepted_theta.append(tree["theta_buf"][lo:lo + c])
                self.state.accepted_dist.append(tree["dist_buf"][lo:lo + c])
        self.eps_schedule = list(meta.get("eps_schedule", []))
        if meta.get("done"):
            self.result = ScenarioResult(**{
                **dataclasses.asdict(self.result), **meta["result"],
                "eps_schedule": tuple(meta["result"]["eps_schedule"]),
                "status": "resumed_complete", "device": self.result.device,
            })
            self.done = True
        return float(meta["tolerance"])

    # ------------------------------------------------------------- driving
    def launch(self):
        """Enqueue one segment; nothing here waits for the device."""
        run_idx, every = self.state.run_idx, self.cfg.checkpoint_every
        seg = min(SEGMENT_WAVES, self.abc_cfg.max_runs - run_idx)
        if every:
            seg = min(seg, every - run_idx % every)
        self._out = self.runner(self.sc.seed, run_idx, self.carry, seg)

    def complete_segment(self):
        """Read the segment (its one host sync), finish or carry on, and
        checkpoint at a multiple of `checkpoint_every` or at the finish."""
        out, self._out = self._out, None
        waves, n_acc, fill = self.runner.read(out)
        self.state.run_idx += waves
        self.state.simulations += waves * self.cfg.batch_size
        self.carry = self.runner.carry_of(out)
        hit_target = n_acc >= self.cfg.target_accepted
        if hit_target or self.state.run_idx >= self.abc_cfg.max_runs:
            self.done = True
            self.runner.harvest(out, self.state, fill)
            self._finalize(hit_target)
        every = self.cfg.checkpoint_every
        if self.done or (every and self.state.run_idx % every == 0):
            self._checkpoint(out, n_acc, fill)
        if self.verbose:
            print(f"[campaign] {self.sc.name}: run {self.state.run_idx}, "
                  f"accepted {n_acc}/{self.cfg.target_accepted}")

    def _finalize(self, hit_target: bool):
        theta, _ = self.state.to_arrays()
        names = run_param_names(self.abc_cfg, get_model(self.sc.model))
        r = self.result
        r.status = "ok" if hit_target else "budget_exhausted"
        r.n_accepted = int(theta.shape[0])
        r.runs = self.state.run_idx
        r.simulations = self.state.simulations
        r.acceptance_rate = r.n_accepted / max(r.simulations, 1)
        r.wall_time_s = time.time() - self._t0
        if theta.shape[0]:
            r.posterior_mean = {n: float(m) for n, m in zip(names, theta.mean(axis=0))}
            r.posterior_std = {n: float(s) for n, s in zip(names, theta.std(axis=0))}

    def _checkpoint(self, out, n_accepted: int, fill):
        # a spec-object model goes into the metadata by its name
        sc_meta = dataclasses.asdict(dataclasses.replace(self.sc, model=self.sc.model_tag))
        fills = [fill] if isinstance(fill, int) else list(fill)
        meta = {
            "scenario": sc_meta,
            "run_idx": self.state.run_idx,
            "simulations": self.state.simulations,
            "n_accepted": n_accepted,
            "fill": sum(fills),
            "fills": fills,
            "tolerance": self.result.tolerance,
            "eps_schedule": list(self.eps_schedule),
            "done": self.done,
        }
        if self.done:
            meta["result"] = dataclasses.asdict(self.result)
        # each segment's first `capacity` rows (the spare rows are not
        # state), copied to the host here, written on the checkpointer's
        # thread
        theta, dist, _ = self.runner.segments(out)
        self.ckpt.save_async(self.state.run_idx, {"theta_buf": theta, "dist_buf": dist}, meta)


def _devices(device) -> List[torch.device]:
    """Every card for "cuda", the devices of a list as listed (one may come
    more than once), else the one device asked for."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def run_campaign(cfg: CampaignConfig, verbose: bool = False,
                 device="cuda") -> CampaignReport:
    """Run (or resume) every scenario of the grid on `device` ("cuda": the
    scenarios round-robin over the cards; "cpu": the plain version; a list
    of devices: over those, a device named twice counting twice); write the
    report to `<out_dir>/campaign_report.json` and return it. With
    `devices_per_scenario` k the devices form disjoint groups of k, any
    remainder left idle."""
    t0 = time.time()
    devices = _devices(device)
    k = cfg.devices_per_scenario
    if k > len(devices):
        raise ValueError(
            f"devices_per_scenario={k} exceeds the {len(devices)} visible devices; "
            "pass a device list that names a device more than once (e.g. "
            "['cuda:0'] * 4 or ['cpu'] * 4) to form groups on fewer devices"
        )
    groups = [list(enumerate(devices))[g * k:(g + 1) * k] for g in range(len(devices) // k)]
    cache = _ShapeCache(cfg)
    runs = [_ScenarioRun(sc, cfg, cache, groups[i % len(groups)], verbose=verbose)
            for i, sc in enumerate(cfg.scenarios())]
    active = [r for r in runs if not r.done]
    while active:
        for r in active:  # enqueue one segment of each
            r.launch()
        for r in active:  # then read them in order
            r.complete_segment()
        active = [r for r in active if not r.done]
    for r in runs:  # drain the writes in flight (raises their I/O errors)
        if r.ckpt is not None:
            r.ckpt.wait()

    report = CampaignReport(
        config=dataclasses.asdict(dataclasses.replace(
            cfg, models=tuple(m if isinstance(m, str) else m.name for m in cfg.models))),
        scenarios=[r.result for r in runs],
        wall_time_s=time.time() - t0,
        compiled_shapes=cache.n_compiled,
    )
    path = report.save(Path(cfg.out_dir) / "campaign_report.json")
    if verbose:
        print(report.summary_table())
        print(f"[campaign] report saved to {path}")
    return report
