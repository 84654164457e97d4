"""The paper's workload on the port: rejection ABC from the CLI.

Single-run mode of `repro.launch.abc_run`, with the same flag names
(`--wave-loop` and `--autotune` among them), plus `--device` (default cuda)
and `--block`:

    PYTHONPATH=src python -m repro_torch.launch.abc_run --dataset italy \\
        --days 49 --batch 100000 --chunk 10000 --auto-tolerance 1e-4 \\
        --accept 100

    # the plain PyTorch path on the CPU, at a small size
    PYTHONPATH=src python -m repro_torch.launch.abc_run --device cpu \\
        --dataset synthetic_small --days 10 --batch 1024 --chunk 256 \\
        --auto-tolerance 0.05 --accept 10 --max-runs 5

    # another registered model (seiard fits the country series), and an
    # inferred contact-rate scale from day 25 on
    PYTHONPATH=src python -m repro_torch.launch.abc_run --model seiard \\
        --dataset italy --days 49 --batch 100000 --chunk 10000 \\
        --auto-tolerance 1e-4 --accept 100 --intervention "alpha0@25=0:2"

    # the 4-region metapopulation SEIR, and the README's 100-region case
    PYTHONPATH=src python -m repro_torch.launch.abc_run --model metapop_seir \
        --dataset synthetic_small --days 49 --batch 100000 --chunk 10000 \
        --auto-tolerance 1e-4 --accept 100
    PYTHONPATH=src python -m repro_torch.launch.abc_run --model metapop_seir \
        --regions 100 --mobility ring:0.1 --dataset synthetic_small --days 49 \
        --batch 20000 --chunk 2000 --auto-tolerance 1e-3 --accept 20

    # a campaign: 3 countries x (siard, seiard) in one process, one report
    # and per-scenario checkpoints under --out; a second call resumes
    PYTHONPATH=src python -m repro_torch.launch.abc_run --campaign \
        --datasets italy new_zealand usa --models siard seiard --days 49 \
        --batch 100000 --auto-tolerance 1e-4 --accept 100 --out /tmp/camp

    # amortized inference (NPE): train an estimator on fresh simulations,
    # then one forward pass for the dataset's series; --npe-* size it
    PYTHONPATH=src python -m repro_torch.launch.abc_run --backend npe \
        --model sir --dataset synthetic_small --days 15 --accept 256 \
        --npe-steps 300

    # the README's forecast: fit, then 28 days of posterior-predictive bands
    # (strict JSON) past the 49 fitted ones; --forecast-schedule "alpha@25=0.5"
    # asks for a counterfactual instead, "none" lifts every intervention
    PYTHONPATH=src python -m repro_torch.launch.abc_run --dataset italy \
        --days 49 --batch 100000 --chunk 10000 --intervention "alpha0@20=0:2" \
        --auto-tolerance 1e-3 --forecast 28 --forecast-out /tmp/bands.json

    # scale-out (core.distributed): one rank a card over NCCL under torchrun,
    # or gloo ranks on the CPU; --multi-device shards the run's waves over
    # the ranks (a world of 1 without torchrun), --scaling runs the weak
    # scaling study at every --scaling-devices count (--batch a device)
    torchrun --nproc-per-node 4 -m repro_torch.launch.abc_run --multi-device \
        --wave-loop device --dataset italy --days 49 --batch 400000 \
        --chunk 400000 --auto-tolerance 1e-4 --accept 100
    torchrun --nproc-per-node 2 -m repro_torch.launch.abc_run --scaling \
        --device cpu --models sir --batch 512 --days 12 --scaling-devices 1 2 \
        --scaling-waves 2 --scaling-reps 1 --scaling-out /tmp/scaling.json

`--backend npe` runs single-run mode only; with it `--auto-tolerance`,
`--state` and `--multi-device` are refused (an estimator has no
tolerance, no waves to resume and no waves to shard), and `--npe-*` need
it. `--campaign` reads the grid flags (`--datasets`, `--models`,
`--backends`, `--seeds`, `--interventions`, `--summaries`) and refuses
their singular forms, as `repro` does; the grid flags need `--campaign`.
`--scaling` reads `--models`, `--backends`, `--dataset`, `--days` and
`--batch` (a device), refuses `--regions`/`--mobility` and npe, and the
`--scaling-*` flags need it. `--autotune` takes the block of every
mode's simulators from the tuning cache (`core.tuning`). Under several
ranks only rank 0 prints and writes files. `--forecast` delegates to
`core.serving.forecast_bands`, the path `serve --epi` answers from.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os

from repro_torch.core.abc import (
    ABCConfig,
    ABCState,
    calibrate_tolerance,
    run_abc,
    writes_files,
)
from repro_torch.core.campaign import BACKENDS, CampaignConfig, run_campaign
from repro_torch.core.summaries import DISTANCE_KINDS, list_summaries
from repro_torch.epi.data import get_dataset, list_datasets
from repro_torch.epi.models import get_model, list_models
from repro_torch.epi.spec import EMPTY_SCHEDULE, InterventionSchedule, regionalize
from repro_torch.ioutils import atomic_write_text
from repro_torch.kernels.abc_sim import DEFAULT_BLOCK, WARP_DEFAULT_BLOCK


def parse_intervention(spec: str) -> InterventionSchedule | None:
    """Parse an intervention schedule from its CLI string form (the grammar
    of `repro.launch.abc_run.parse_intervention`).

        PARAMS@WINDOW[,WINDOW...]
        PARAMS := name[+name...]            scaled (time-varying) parameters
        WINDOW := day[=SCALES]              new window starting at `day`
        SCALES := entry[+entry...]          one entry, or one per tv param
        entry  := x (pinned scale) | lo:hi (inferred under U(lo, hi))

    A bare `day` infers that window's scales under the default U(0, 2).
    Examples: "alpha@25=0.3" (contact rate pinned to 0.3x from day 25),
    "alpha@25=0.1:1,40" (inferred lockdown window, then a second inferred
    reopening window), "alpha+gamma@30=0.5+0.8".
    """
    spec = (spec or "").strip()
    if not spec or spec.lower() == "none":
        return None
    if "@" not in spec:
        raise ValueError(
            f"intervention {spec!r}: expected PARAMS@day[=scale][,day...]"
        )
    params_s, windows_s = spec.split("@", 1)
    tv_params = tuple(p.strip() for p in params_s.split("+") if p.strip())
    if not tv_params:
        raise ValueError(f"intervention {spec!r}: no parameter names before '@'")
    breakpoints, lows, highs = [], [], []
    for win in windows_s.split(","):
        win = win.strip()
        day_s, _, scales_s = win.partition("=")
        breakpoints.append(int(day_s))
        if not scales_s:
            entries = ["0:2"] * len(tv_params)
        else:
            entries = scales_s.split("+")
            if len(entries) == 1:
                entries = entries * len(tv_params)
        if len(entries) != len(tv_params):
            raise ValueError(
                f"intervention {spec!r}: window {win!r} has {len(entries)} "
                f"scales for {len(tv_params)} parameters"
            )
        lo_row, hi_row = [], []
        for e in entries:
            lo_s, _, hi_s = e.partition(":")
            lo_row.append(float(lo_s))
            hi_row.append(float(hi_s) if hi_s else float(lo_s))
        lows.append(tuple(lo_row))
        highs.append(tuple(hi_row))
    return InterventionSchedule(
        tv_params=tv_params,
        breakpoints=tuple(breakpoints),
        scale_lows=tuple(lows),
        scale_highs=tuple(highs),
    )


def posterior_forecast(
    theta,
    dataset,
    cfg: ABCConfig,
    horizon: int,
    schedule: InterventionSchedule | None = None,
    key: int = 0,
    quantiles=(0.05, 0.25, 0.5, 0.75, 0.95),
    max_particles: int = 512,
    device="cuda",
) -> dict:
    """Posterior-predictive forecast: simulate accepted particles forward
    past the fitting horizon under a chosen schedule; returns credible bands.

    `theta` is the accepted sample set [N, p]; `schedule` defaults to the
    FIT schedule (cfg.schedule); pass a different fixed-scale schedule for
    a counterfactual ("what if the lockdown lifts on day 60 instead"). The
    result is a strict-JSON-serializable dict: per observed channel, the
    mean and the requested quantiles over particles for every day of
    `cfg.num_days + horizon`.

    Sets larger than `max_particles` are subsampled with a seeded
    permutation (not truncated: topk accepted sets are distance-ordered).
    Delegates to `repro_torch.core.serving.forecast_bands` on `device`, the
    path the `serve --epi` batch server answers from; `key` is the seed.
    """
    from repro_torch.core.serving import forecast_bands

    return forecast_bands(
        theta,
        dataset,
        model=cfg.model,
        fit_days=cfg.num_days,
        horizon=horizon,
        fit_schedule=cfg.schedule,
        schedule=schedule,
        key=key,
        quantiles=quantiles,
        max_particles=max_particles,
        device=device,
    )


#: (grid flag, singular flag) pairs of campaign mode
GRID_FLAGS = (("--datasets", "--dataset"), ("--models", "--model"), ("--seeds", "--seed"),
              ("--interventions", "--intervention"), ("--summaries", "--summary"))


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def run_scaling_cli(args):
    """`--scaling`: the paper's multi-device experiment as one command, over
    the ranks of the default process group (torchrun's, or a world of 1):
    the sharded device wave loop at every --scaling-devices count, weak
    scaling with --batch a device; rank 0 prints the table and writes
    --scaling-out and returns the report, the other ranks return None."""
    from repro_torch.core.scaling import ScalingConfig, format_report, run_scaling_study

    scfg = ScalingConfig(
        device_counts=tuple(args.scaling_devices),
        models=tuple(args.models),
        backends=tuple(args.backends),
        batch_per_device=args.batch,
        waves=args.scaling_waves,
        num_days=args.days,
        dataset=args.dataset,
        reps=args.scaling_reps,
        block=args.block,
        autotune=args.autotune,
    )
    report = run_scaling_study(scfg, verbose=True, device=args.device)
    if report is None:
        return None
    print()
    print(format_report(report))
    if args.scaling_out:
        atomic_write_text(args.scaling_out, json.dumps(report, indent=1, allow_nan=False))
        print(f"[scaling] report saved to {args.scaling_out}")
    return report


def run_campaign_cli(args, parser):
    """`--campaign`: the grid of the plural flags through `run_campaign`."""
    # the grid reads only the plural flags; a singular one would be ignored
    for _, flag in GRID_FLAGS:
        if getattr(args, _dest(flag)) != parser.get_default(_dest(flag)):
            parser.error(f"{flag} has no effect with --campaign; use the grid flag "
                         f"{flag}s instead")
    models = tuple(args.models)
    if args.regions > 1:
        # every grid model regionalized; the shape cache keys on the spec
        models = tuple(regionalize(get_model(m), args.regions, args.mobility or "identity")
                       for m in models)
    cfg = CampaignConfig(
        datasets=tuple(args.datasets),
        models=models,
        backends=tuple(args.backends),
        seeds=tuple(args.seeds),
        interventions=tuple(parse_intervention(s) for s in args.interventions),
        summaries=tuple(None if s == "identity" else s for s in args.summaries),
        distance=args.distance,
        batch_size=args.batch,
        num_days=args.days,
        target_accepted=args.accept,
        max_runs=args.max_runs,
        tolerance=None if args.auto_tolerance else args.tolerance,
        auto_quantile=args.auto_tolerance or 1e-3,
        out_dir=args.out,
        checkpoint_every=args.checkpoint_every,
        devices_per_scenario=args.devices_per_scenario,
        block=args.block,
        autotune=args.autotune,
    )
    return run_campaign(cfg, verbose=True, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Rejection ABC of a compartmental model (PyTorch/CUDA port)"
    )
    ap.add_argument("--dataset", default="synthetic_small", choices=list_datasets())
    ap.add_argument("--model", default="siard", choices=list_models())
    ap.add_argument("--regions", type=int, default=1,
                    help="regionalize --model into an N-region metapopulation "
                         "(epi.spec.regionalize); only a model with coupled "
                         "compartments (metapop_seir) exchanges mass between regions, "
                         "any other becomes N independent copies. 1 = the model as "
                         "registered")
    ap.add_argument("--mobility", default="",
                    help="mobility matrix for --regions > 1: 'identity' (uncoupled), "
                         "'uniform:EPS' or 'ring:EPS' (epi.spec.make_mobility); "
                         "default identity")
    ap.add_argument("--tolerance", type=float, default=1.6e4,
                    help="absolute epsilon; use --auto-tolerance to calibrate")
    ap.add_argument("--auto-tolerance", type=float, default=0.0, metavar="Q",
                    help="pick epsilon as the Q-quantile of a pilot wave")
    ap.add_argument("--accept", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--days", type=int, default=20)
    ap.add_argument("--strategy", default="outfeed", choices=["outfeed", "topk"])
    ap.add_argument("--backend", default="cuda", choices=["cuda", "npe"],
                    help="cuda: rejection ABC on the fused kernel (its plain version "
                         "on the CPU); npe: train an amortized estimator, then sample "
                         "it (single-run mode only)")
    ap.add_argument("--npe-steps", type=int, default=None,
                    help="backend=npe: training steps (default NPEConfig)")
    ap.add_argument("--npe-batch", type=int, default=None,
                    help="backend=npe: fresh simulations per training step")
    ap.add_argument("--npe-hidden", type=int, default=None,
                    help="backend=npe: MDN trunk width")
    ap.add_argument("--npe-components", type=int, default=None,
                    help="backend=npe: mixture components")
    ap.add_argument("--wave-loop", default="auto", choices=["auto", "host", "device"],
                    help="ABC wave loop: 'device' enqueues segments of gated waves "
                         "with a device accept buffer (one host sync a segment), 'host' "
                         "harvests every wave; 'auto' picks device for outfeed runs. "
                         "Both give the same accepted set")
    ap.add_argument("--summary", default="identity", choices=list(list_summaries()))
    ap.add_argument("--distance", default="euclidean", choices=sorted(DISTANCE_KINDS))
    ap.add_argument("--intervention", default="",
                    help="piecewise-constant intervention schedule, e.g. "
                         "'alpha0@25=0.1:1' (scale alpha0 from day 25 on, inferred "
                         "under U(0.1, 1)); see parse_intervention for the grammar")
    ap.add_argument("--max-runs", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state", default="", help="checkpoint path (resume if exists)")
    ap.add_argument("--save-posterior", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the fused kernel; cpu its plain PyTorch version")
    ap.add_argument("--block", type=int, default=None,
                    help="CUDA block size in threads (default: the kernel's own, "
                         f"{DEFAULT_BLOCK}, or {WARP_DEFAULT_BLOCK} on the regional warp "
                         "route; distances do not depend on it)")
    ap.add_argument("--autotune", action="store_true",
                    help="resolve --block from the measured tuning cache "
                         "(experiments/tuning/cache_torch.json) when the simulator is "
                         "made (a cache miss runs the best-of-N search once and "
                         "persists the winner; see repro_torch.core.tuning). Single "
                         "runs, --campaign and --scaling; an explicit --block wins")
    # campaign mode
    ap.add_argument("--campaign", action="store_true",
                    help="run a dataset x model x backend x seed (x intervention x summary) "
                         "grid with per-scenario checkpoints and one report")
    ap.add_argument("--datasets", nargs="+", default=["italy", "new_zealand", "usa"],
                    choices=list_datasets(), help="campaign dataset grid axis")
    ap.add_argument("--models", nargs="+", default=["siard"], choices=list_models(),
                    help="campaign model grid axis")
    ap.add_argument("--backends", nargs="+", default=list(BACKENDS), choices=list(BACKENDS),
                    help="campaign backend grid axis (the port has the cuda backend only)")
    ap.add_argument("--seeds", nargs="+", type=int, default=[0],
                    help="campaign seed grid axis")
    ap.add_argument("--out", default="experiments/campaigns/default",
                    help="campaign output directory (checkpoints and the report)")
    ap.add_argument("--checkpoint-every", type=int, default=32,
                    help="a campaign scenario checkpoints at every multiple of this many "
                         "waves and when it finishes (0: only when it finishes)")
    ap.add_argument("--devices-per-scenario", type=int, default=1,
                    help="devices a campaign scenario is sharded over: the cards are "
                         "carved into disjoint groups of this many, and each scenario "
                         "runs the lockstep reference of that many shards, shard s on "
                         "its group's s-th card (at most the cards visible; the CPU is "
                         "one device)")
    # scale-out
    ap.add_argument("--multi-device", action="store_true",
                    help="shard each wave over the ranks of the process group (torchrun "
                         "--nproc-per-node N: one rank a card over NCCL, or gloo ranks "
                         "with --device cpu; a world of 1 without torchrun); "
                         "--wave-loop device runs the sharded device loop, else the "
                         "sharded host loop")
    ap.add_argument("--scaling", action="store_true",
                    help="run the multi-device scaling study (the paper's 16-IPU "
                         "experiment): sharded wave loop at every --scaling-devices "
                         "count, weak scaling with --batch per device, "
                         "efficiency/overhead per (model, backend) cell from "
                         "--models/--backends")
    ap.add_argument("--scaling-devices", nargs="+", type=int, default=[1, 2, 4, 8],
                    help="device counts of the curve (the first ranks of the process "
                         "group)")
    ap.add_argument("--scaling-waves", type=int, default=4,
                    help="fixed wave budget per scaling cell")
    ap.add_argument("--scaling-reps", type=int, default=3,
                    help="timed repetitions per cell (best-of)")
    ap.add_argument("--scaling-out", default="",
                    help="path for the scaling report JSON (default: stdout table "
                         "only)")
    ap.add_argument("--interventions", nargs="+", default=["none"],
                    help="campaign intervention grid axis (schedule strings; 'none' is "
                         "the constant-theta cell); schedules of one shape share a "
                         "shape-cache entry")
    ap.add_argument("--summaries", nargs="+", default=["identity"],
                    choices=list(list_summaries()),
                    help="campaign summary-statistic grid axis")
    # forecast mode
    ap.add_argument("--forecast", type=int, default=0, metavar="DAYS",
                    help="after fitting, simulate the accepted particles DAYS past the "
                         "horizon and emit posterior-predictive credible bands as strict "
                         "JSON")
    ap.add_argument("--forecast-schedule", default="",
                    help="counterfactual schedule for the forecast (fixed scales only); "
                         "default: forecast under the FIT schedule; 'none': forecast "
                         "with interventions lifted")
    ap.add_argument("--forecast-out", default="",
                    help="path for the forecast JSON (default: stdout)")
    args = ap.parse_args(argv)
    if args.regions < 1:
        ap.error("--regions must be >= 1")
    if args.mobility and args.regions == 1:
        ap.error("--mobility has no effect without --regions > 1")
    if args.scaling and (args.regions > 1 or args.mobility):
        ap.error("--regions/--mobility are not supported with --scaling; "
                 "regionalized specs go through single-run or --campaign")
    if args.backend == "npe":
        if args.campaign or args.scaling:
            ap.error("backend 'npe' is not a campaign/scaling grid axis (it has no "
                     "wave loop to shard); use the single-run --backend npe")
        if args.multi_device:
            ap.error("--multi-device has no effect with --backend npe: training is "
                     "a single-device loop")
        if args.auto_tolerance:
            ap.error("--auto-tolerance is wave-backend-only; backend npe has no "
                     "tolerance (its posterior is a density estimator)")
        if args.state:
            ap.error("--state is wave-backend-only; NPE runs are not "
                     "checkpoint/resumable (re-train or fine-tune instead)")
        if args.autotune:
            ap.error("--autotune tunes the cuda backend's block; backend npe has none")
    npe_overrides = {
        k: v for k, v in (("train_steps", args.npe_steps), ("train_batch", args.npe_batch),
                          ("hidden", args.npe_hidden), ("n_components", args.npe_components))
        if v is not None
    }
    if npe_overrides and args.backend != "npe":
        ap.error("--npe-* flags have no effect without --backend npe")
    if args.campaign:
        return run_campaign_cli(args, ap)
    if args.scaling:
        return _on_ranks(args, run_scaling_cli, args)
    # the grid flags do nothing without --campaign: refuse them
    for flag, singular in GRID_FLAGS:
        if getattr(args, _dest(flag)) != ap.get_default(_dest(flag)):
            ap.error(f"{flag} has no effect without --campaign; use the singular flag "
                     f"{singular} instead")
    for flag in ("--scaling-devices", "--scaling-waves", "--scaling-reps", "--scaling-out"):
        if getattr(args, _dest(flag)) != ap.get_default(_dest(flag)):
            ap.error(f"{flag} has no effect without --scaling")
    if args.multi_device:
        return _on_ranks(args, run_single, args, npe_overrides)
    return run_single(args, npe_overrides)


def _on_ranks(args, fn, *fn_args):
    """`fn(*fn_args)` inside the default process group
    (`distributed.world`); on ranks other than 0 its output goes nowhere."""
    from repro_torch.core import distributed

    with distributed.world(args.device):
        distributed.rank_device(args.device)  # this rank's card before any launch
        quiet = (contextlib.nullcontext() if writes_files()
                 else contextlib.redirect_stdout(io.StringIO()))
        with quiet:
            return fn(*fn_args)


def run_single(args, npe_overrides):
    """Single-run mode: one posterior (sharded over the process group's
    ranks under --multi-device); rank 0 alone writes files."""
    model = args.model
    if args.regions > 1:
        model = regionalize(get_model(args.model), args.regions, args.mobility or "identity")
    ds = get_dataset(args.dataset, num_days=args.days, model=model)
    schedule = parse_intervention(args.intervention)
    tolerance = args.tolerance
    if args.auto_tolerance:
        pilot_cfg = ABCConfig(batch_size=args.batch, tolerance=1.0,
                              num_days=args.days, strategy="topk", top_k=1,
                              model=model, summary=args.summary,
                              distance=args.distance, block=args.block,
                              schedule=schedule)
        tolerance = calibrate_tolerance(ds, pilot_cfg, seed=args.seed,
                                        quantile=args.auto_tolerance,
                                        device=args.device)
        print(f"[abc] auto-calibrated tolerance = {tolerance:.4g} "
              f"(quantile {args.auto_tolerance:g})")
    npe_cfg = None
    if npe_overrides:
        from repro_torch.core.npe import NPEConfig

        npe_cfg = NPEConfig(**npe_overrides)
    cfg = ABCConfig(
        batch_size=args.batch,
        tolerance=tolerance,
        target_accepted=args.accept,
        strategy=args.strategy,
        chunk_size=args.chunk,
        num_days=args.days,
        backend=args.backend,
        max_runs=args.max_runs,
        model=model,
        summary=args.summary,
        distance=args.distance,
        block=args.block,
        schedule=schedule,
        wave_loop=args.wave_loop,
        npe=npe_cfg,
        autotune=args.autotune,
    )
    wave_runner = run_fn = None
    if args.multi_device:
        from repro_torch.core import distributed

        if args.wave_loop == "device":
            wave_runner = distributed.make_wave_runner(None, ds, cfg, device=args.device)
        else:
            run_fn = distributed.make_runner(None, ds, cfg, device=args.device)
    state = None
    if args.state and os.path.exists(args.state):
        state = ABCState.load(args.state)
        print(f"[abc] resuming from run {state.run_idx} "
              f"({state.n_accepted} accepted)")
    post = run_abc(
        ds, cfg, seed=args.seed, state=state,
        checkpoint_every=25 if args.state else 0,
        checkpoint_path=args.state or None, verbose=True, device=args.device,
        wave_runner=wave_runner, run_fn=run_fn,
    )
    print(post.summary_table())
    if not writes_files():
        return post
    if args.save_posterior:
        post.save(args.save_posterior)
        print(f"[abc] posterior saved to {args.save_posterior}")
    if args.forecast:
        if args.forecast_schedule:
            # an explicit counterfactual; "none" lifts every intervention
            fc_sched = parse_intervention(args.forecast_schedule) or EMPTY_SCHEDULE
        else:
            fc_sched = None  # forecast under the fit schedule
        bands = posterior_forecast(post.theta, ds, cfg, args.forecast, schedule=fc_sched,
                                   key=args.seed + 1, device=args.device)
        text = json.dumps(bands, indent=1, allow_nan=False)
        if args.forecast_out:
            atomic_write_text(args.forecast_out, text)
            print(f"[abc] forecast bands saved to {args.forecast_out}")
        else:
            print(text)
    return post


if __name__ == "__main__":
    main()
