"""LM training CLI (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \
        --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ck --ckpt-every 10 --device cpu

It runs on the card unless `--device cpu` is given: `build_train_step` on
one device (autograd, then `repro`'s AdamW updating the parameters and
moments in place), asynchronous checkpoints with resume
(`repro_torch.checkpoint.Checkpointer`), and the deterministic (step,
shard)-addressed synthetic data of `repro_torch.data`, so that a restart
does not change the sample stream. Parameters come from a generator seeded
0 on the device.

As `repro`'s, it refuses the families it does not train: it drives token-LM
training of the decoder, ssm and hybrid families. `--mesh single|multi`
(the production meshes) are refused: the N-rank step comes with the
sharding slice. `--compress-grads` is parsed and not read, as in `repro`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticTokenDataset
from repro_torch.device import resolve_device
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

#: the families the CLI trains, as in `repro`
TRAIN_FAMILIES = ("decoder", "ssm", "hybrid")


def state_arrays(params, opt_state) -> dict:
    """The training state as the checkpointer's flat dict: "params/<i>",
    "mu/<i>", "nu/<i>" for the i-th leaf in `tree_leaves` order, and
    "step". bf16 leaves are saved as float32 (an exact widening)."""
    def host(t):
        return t.to(torch.float32) if t.dtype == torch.bfloat16 else t

    out = {"step": opt_state["step"]}
    for prefix, tree in (("params", params), ("mu", opt_state["mu"]), ("nu", opt_state["nu"])):
        out.update({f"{prefix}/{i:05d}": host(t) for i, t in enumerate(tree_leaves(tree))})
    return out


def state_from_arrays(arrays: dict, params, opt_state):
    """(params, opt_state) like the given ones, their leaves read from
    `arrays` (`state_arrays`' names) in their own dtypes and devices."""
    def load(prefix, tree):
        leaves = tree_leaves(tree)
        return tree_unflatten(tree, [torch.from_numpy(np.asarray(arrays[f"{prefix}/{i:05d}"]))
                                     .to(device=t.device, dtype=t.dtype)
                                     for i, t in enumerate(leaves)])

    step = opt_state["step"]
    return load("params", params), {
        "mu": load("mu", opt_state["mu"]), "nu": load("nu", opt_state["nu"]),
        "step": torch.as_tensor(np.asarray(arrays["step"])).to(device=step.device,
                                                               dtype=step.dtype)}


def main(argv=None) -> dict:
    """Train; returns {"loss": the last step's loss, "losses": each step's,
    "step_ms": each step's milliseconds (CUDA events on the card, the host
    clock on the CPU), "start_step", "steps", "tokens_per_s", "seconds"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"],
                    help="host: this one device; single|multi wait for the sharding slice")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="parsed and not read, as in repro (optim.compress is not wired in)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise SystemExit(f"--mesh {args.mesh}: the production meshes and the N-rank train "
                         f"step come with the sharding slice (models/sharding.py, "
                         f"launch/mesh.py); this CLI trains on one device (--mesh host)")
    model = get_model(args.arch, smoke=args.smoke)
    if model.family not in TRAIN_FAMILIES:
        raise SystemExit("train.py drives token-LM training; use the benchmarks for "
                         f"family={model.family}")
    dev = resolve_device(args.device)
    shape = InputShape("cli", "train", args.seq, args.batch)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5 + 1))
    ds = SyntheticTokenDataset(vocab=model.vocab, seq_len=args.seq, seed=0)

    built = build_train_step(model, shape, opt_cfg=opt_cfg, donate=True)
    params = model.init_params(device=dev)
    opt_state = adamw_init(params)

    start_step = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and args.resume and ck.steps():
        arrays, _, start_step = ck.restore(state_arrays(params, opt_state))
        params, opt_state = state_from_arrays(arrays, params, opt_state)
        print(f"[train] resumed from step {start_step}")

    cuda = dev.type == "cuda"
    losses, marks = [], []
    t0 = time.time()
    tokens_seen = 0
    for step in range(start_step, args.steps):
        raw = ds.batch(step, args.batch)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        start = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
        if cuda:
            start.record()
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = time.perf_counter()
        marks.append((start, end))
        losses.append(metrics["loss"])
        tokens_seen += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} tok/s={tokens_seen / (time.time() - t0):.0f}", flush=True)
        if ck and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ck.save_async(step + 1, state_arrays(params, opt_state),
                          metadata={"arch": args.arch})
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    if ck:
        ck.wait()
        ck.save(args.steps, state_arrays(params, opt_state), metadata={"arch": args.arch})
    print(f"[train] done in {seconds:.1f}s")
    step_ms = [s.elapsed_time(e) if cuda else (e - s) * 1e3 for s, e in marks]
    losses = [float(x) for x in losses]
    return {"loss": losses[-1] if losses else None, "losses": losses, "step_ms": step_ms,
            "start_step": start_step, "steps": args.steps, "seconds": seconds,
            "tokens_per_s": tokens_seen / seconds if seconds > 0 else None}


if __name__ == "__main__":
    main()
