"""Posterior re-fit daemon: watch datasets, re-fit, atomically swap (port of
`repro.launch.abc_serve`).

    # one sweep (CI / cron): re-fit anything whose data content changed
    PYTHONPATH=src python -m repro_torch.launch.abc_serve --once \\
        --data-dir data/ --store store/ --models siard --days 21

    # daemon: poll for dataset updates (e.g. new daily rows) forever
    PYTHONPATH=src python -m repro_torch.launch.abc_serve \\
        --data-dir data/ --store store/ --interval 300

    # the plain PyTorch path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.abc_serve --once --device cpu \\
        --data-dir data/ --store store/ --models sir --days 8 \\
        --fit-particles 16 --fit-batch 256 --fit-rounds 1

The serving split (see repro_torch.core.serving): `serve --epi` answers
queries from the posterior store; THIS process keeps the store fresh. Each
sweep hashes every `<name>.json` dataset's content and, for each (dataset,
model) pair whose version moved past the stored fit, re-fits the posterior
and swaps the store entry atomically (tmp+rename on both the .npz and the
index). A daemon crash mid-fit leaves the previous complete entry being
served.

The re-fit is SMC-ABC on the device round (`core.smc`, the theta-in entry
of the CUDA kernel on the card), WARM-STARTED from the previous version's
weighted population (`SMCConfig.initial_particles`): new daily rows barely
move a posterior, so round 0 costs n_particles simulations instead of a
full prior wave. `--backend npe` keeps one amortized estimator a (model,
summary, schedule) instead (`core.npe`): trained on the first sweep, saved
under `<store>/npe/`, and fine-tuned by `--npe-fine-tune` steps (0: a free
refresh) when a version moves; a refresh runs no wave.

    PYTHONPATH=src python -m repro_torch.launch.abc_serve --once --device cpu \\
        --data-dir data/ --store store/ --models sir --days 8 --fit-particles 16 \\
        --backend npe --npe-steps 30 --npe-fine-tune 2
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def sweep(server, data_dir: str, models) -> dict:
    """One pass over every dataset file x model; returns status counts."""
    counts = {"cached": 0, "warm_refit": 0, "cold_fit": 0, "error": 0}
    paths = sorted(glob.glob(os.path.join(data_dir, "*.json")))
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        if name == "index":
            continue
        for model in models:
            try:
                status = server.refresh(name, model)
            except (ValueError, FileNotFoundError) as e:
                print(f"[abc_serve] {name}/{model}: SKIP ({e})",
                      file=sys.stderr)
                counts["error"] += 1
                continue
            counts[status] += 1
            if status != "cached":
                print(f"[abc_serve] {name}/{model}: {status}",
                      file=sys.stderr)
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True,
                    help="directory of <name>.json dataset files to watch")
    ap.add_argument("--store", required=True,
                    help="posterior-store directory to keep fresh")
    ap.add_argument("--models", nargs="+", default=["siard"],
                    help="models to maintain a posterior for, per dataset")
    ap.add_argument("--once", action="store_true",
                    help="one sweep, then exit (returns the number of re-fits)")
    ap.add_argument("--interval", type=float, default=300.0,
                    help="seconds between sweeps in daemon mode")
    ap.add_argument("--max-sweeps", type=int, default=0,
                    help="stop after N sweeps (0 = forever; testing hook)")
    ap.add_argument("--days", type=int, default=21,
                    help="SMC fit window (days of observed data)")
    ap.add_argument("--fit-particles", type=int, default=128)
    ap.add_argument("--fit-batch", type=int, default=4096)
    ap.add_argument("--fit-rounds", type=int, default=3)
    ap.add_argument("--fit-quantile", type=float, default=0.5)
    ap.add_argument("--fit-backend", default="cuda", choices=["cuda"],
                    help="simulation backend of the SMC waves (the port's one backend: "
                         "the CUDA kernel, its plain version on the CPU)")
    ap.add_argument("--backend", default="smc", choices=["smc", "npe"],
                    help="refresh mechanism: SMC re-fit waves, or an amortized NPE "
                         "estimator fine-tuned per version")
    ap.add_argument("--npe-steps", type=int, default=None,
                    help="--backend npe: initial training steps (default NPEConfig)")
    ap.add_argument("--npe-fine-tune", type=int, default=None,
                    help="--backend npe: gradient steps per version change "
                         "(0 = zero-cost refresh)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda fits through the fused kernel; cpu its plain PyTorch "
                         "version")
    args = ap.parse_args(argv)

    from repro_torch.core.serving import EpiServer, ServeConfig
    from repro_torch.core.smc import SMCConfig

    if args.backend != "npe" and (args.npe_steps is not None
                                  or args.npe_fine_tune is not None):
        ap.error("--npe-* flags have no effect without --backend npe")
    npe_cfg = None
    if args.backend == "npe":
        from repro_torch.core.npe import NPEConfig

        overrides = {k: v for k, v in (("train_steps", args.npe_steps),
                                       ("fine_tune_steps", args.npe_fine_tune))
                     if v is not None}
        npe_cfg = NPEConfig(**overrides) if overrides else None

    server = EpiServer(ServeConfig(
        fit=SMCConfig(
            n_particles=args.fit_particles,
            batch_size=args.fit_batch,
            n_rounds=args.fit_rounds,
            quantile=args.fit_quantile,
            num_days=args.days,
            backend=args.fit_backend,
            wave_loop="device",
        ),
        fit_seed=args.seed,
        data_dir=args.data_dir,
        store_dir=args.store,
        fit_backend=args.backend,
        npe=npe_cfg,
    ), device=args.device)

    sweeps = 0
    while True:
        counts = sweep(server, args.data_dir, args.models)
        sweeps += 1
        refits = counts["warm_refit"] + counts["cold_fit"]
        print(f"[abc_serve] sweep {sweeps}: {counts}", file=sys.stderr)
        if args.once or (args.max_sweeps and sweeps >= args.max_sweeps):
            return refits
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
