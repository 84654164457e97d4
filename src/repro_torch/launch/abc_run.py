"""The paper's workload on the port: rejection ABC from the CLI.

Single-run mode of `repro.launch.abc_run`, with the same flag names, plus
`--device` (default cuda) and `--block`:

    PYTHONPATH=src python -m repro_torch.launch.abc_run --dataset italy \\
        --days 49 --batch 100000 --chunk 10000 --auto-tolerance 1e-4 \\
        --accept 100

    # the plain PyTorch path on the CPU, at a small size
    PYTHONPATH=src python -m repro_torch.launch.abc_run --device cpu \\
        --dataset synthetic_small --days 10 --batch 1024 --chunk 256 \\
        --auto-tolerance 0.05 --accept 10 --max-runs 5
"""

from __future__ import annotations

import argparse
import os

from repro_torch.core.abc import ABCConfig, ABCState, calibrate_tolerance, run_abc
from repro_torch.core.summaries import DISTANCE_KINDS, list_summaries
from repro_torch.epi.data import get_dataset, list_datasets
from repro_torch.epi.models import list_models
from repro_torch.kernels.abc_sim import DEFAULT_BLOCK


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Rejection ABC of a compartmental model (PyTorch/CUDA port)"
    )
    ap.add_argument("--dataset", default="synthetic_small", choices=list_datasets())
    ap.add_argument("--model", default="siard", choices=list_models())
    ap.add_argument("--tolerance", type=float, default=1.6e4,
                    help="absolute epsilon; use --auto-tolerance to calibrate")
    ap.add_argument("--auto-tolerance", type=float, default=0.0, metavar="Q",
                    help="pick epsilon as the Q-quantile of a pilot wave")
    ap.add_argument("--accept", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--days", type=int, default=20)
    ap.add_argument("--strategy", default="outfeed", choices=["outfeed", "topk"])
    ap.add_argument("--summary", default="identity", choices=list(list_summaries()))
    ap.add_argument("--distance", default="euclidean", choices=sorted(DISTANCE_KINDS))
    ap.add_argument("--max-runs", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state", default="", help="checkpoint path (resume if exists)")
    ap.add_argument("--save-posterior", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the fused kernel; cpu its plain PyTorch version")
    ap.add_argument("--block", type=int, default=DEFAULT_BLOCK,
                    help="CUDA block size in threads (distances do not depend on it)")
    args = ap.parse_args(argv)

    ds = get_dataset(args.dataset, num_days=args.days, model=args.model)
    tolerance = args.tolerance
    if args.auto_tolerance:
        pilot_cfg = ABCConfig(batch_size=args.batch, tolerance=1.0,
                              num_days=args.days, strategy="topk", top_k=1,
                              model=args.model, summary=args.summary,
                              distance=args.distance, block=args.block)
        tolerance = calibrate_tolerance(ds, pilot_cfg, seed=args.seed,
                                        quantile=args.auto_tolerance,
                                        device=args.device)
        print(f"[abc] auto-calibrated tolerance = {tolerance:.4g} "
              f"(quantile {args.auto_tolerance:g})")
    cfg = ABCConfig(
        batch_size=args.batch,
        tolerance=tolerance,
        target_accepted=args.accept,
        strategy=args.strategy,
        chunk_size=args.chunk,
        num_days=args.days,
        max_runs=args.max_runs,
        model=args.model,
        summary=args.summary,
        distance=args.distance,
        block=args.block,
    )
    state = None
    if args.state and os.path.exists(args.state):
        state = ABCState.load(args.state)
        print(f"[abc] resuming from run {state.run_idx} "
              f"({state.n_accepted} accepted)")
    post = run_abc(
        ds, cfg, seed=args.seed, state=state,
        checkpoint_every=25 if args.state else 0,
        checkpoint_path=args.state or None, verbose=True, device=args.device,
    )
    print(post.summary_table())
    if args.save_posterior:
        post.save(args.save_posterior)
        print(f"[abc] posterior saved to {args.save_posterior}")
    return post


if __name__ == "__main__":
    main()
