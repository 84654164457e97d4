"""LM training CLI (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \
        --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ck --ckpt-every 10 --device cpu

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch gemma2-27b --mesh host \
        --steps 20 --batch 16 --seq 2048

It runs on the card unless `--device cpu` is given: `build_train_step`
(autograd, then `repro`'s AdamW updating the parameters and moments in
place), asynchronous checkpoints with resume
(`repro_torch.checkpoint.Checkpointer`), and the deterministic (step,
shard)-addressed synthetic data of `repro_torch.data`, so that a restart
does not change the sample stream. Parameters come from a generator seeded
0 on the device.

`--mesh host` trains on one device, or, launched by torchrun, over the
world's ranks (`launch.mesh.make_host_mesh`: a data axis of every rank, one
card each, NCCL; gloo on the CPU): the meshed step of `launch.steps`, its
AdamW moments ZeRO-1. `--mesh single|multi` build the production meshes
(16x16, 2x16x16) and refuse a world that is not 256 or 512 ranks. On a
mesh every rank builds the seed-0 parameters and keeps its shards; rank 0
alone prints and saves (the state gathered whole), and every rank restores
its own blocks (reshard-on-load).

As `repro`'s, it refuses the families it does not train: it drives token-LM
training of the decoder, ssm and hybrid families. `--compress-grads` is
parsed and not read, as in `repro`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticTokenDataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, production_mesh_shape
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import build_train_step, full_tree, shard_tree
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
    def one(a, t):
        if isinstance(a, torch.Tensor):  # a DTensor restored in its layout
            return a.to(dtype=t.dtype)
        return torch.from_numpy(np.asarray(a)).to(device=t.device, dtype=t.dtype)

    def load(prefix, tree):
        return tree_unflatten(tree, [one(arrays[f"{prefix}/{i:05d}"], t)
                                     for i, t in enumerate(tree_leaves(tree))])

    return load("params", params), {
        "mu": load("mu", opt_state["mu"]), "nu": load("nu", opt_state["nu"]),
        "step": one(arrays["step"], opt_state["step"])}


def state_shardings(in_shardings) -> dict:
    """The layouts of `state_arrays`' leaves for the meshed step's
    (parameters, moments, batch) layouts."""
    p_sh, o_sh = in_shardings[0], in_shardings[1]
    out = {"step": o_sh["step"]}
    for prefix, tree in (("params", p_sh), ("mu", o_sh["mu"]), ("nu", o_sh["nu"])):
        out.update({f"{prefix}/{i:05d}": s for i, s in enumerate(tree_leaves(tree))})
    return out


def _world_size() -> int:
    """The ranks torchrun launched (its WORLD_SIZE), 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _mesh_for(name: str, device):
    """The training mesh of `--mesh` (None: one device, no mesh). The
    production meshes refuse a world of another size."""
    if name != "host":
        shape, axes = production_mesh_shape(name == "multi")
        need = 1
        for n in shape:
            need *= n
        have = _world_size()
        if have != need:
            raise SystemExit(f"--mesh {name} is the {'x'.join(map(str, shape))} {axes} mesh "
                             f"and needs a world of {need} ranks (torchrun, one card a "
                             f"rank); this one has {have}")
    elif _world_size() == 1:
        return None
    from repro_torch.core.distributed import process_group

    process_group(None, device)
    kind = "cuda" if torch.device(device).type == "cuda" else "cpu"
    if name == "host":
        return make_host_mesh(device_type=kind)
    return make_production_mesh(multi_pod=name == "multi", device_type=kind)


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
                    help="host: one device, or torchrun's ranks on a data axis; "
                         "single|multi: the 16x16 and 2x16x16 production meshes")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="parsed and not read, as in repro (optim.compress is not wired in)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    model = get_model(args.arch, smoke=args.smoke)
    if model.family not in TRAIN_FAMILIES:
        raise SystemExit("train.py drives token-LM training; use the benchmarks for "
                         f"family={model.family}")
    mesh = _mesh_for(args.mesh, args.device)
    if mesh is not None:
        from repro_torch.core.distributed import rank_device

        dev = rank_device(args.device)
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    shape = InputShape("cli", "train", args.seq, args.batch)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5 + 1))
    ds = SyntheticTokenDataset(vocab=model.vocab, seq_len=args.seq, seed=0)

    built = build_train_step(model, shape, mesh, opt_cfg=opt_cfg, donate=True)
    params = model.init_params(device=dev)
    opt_state = adamw_init(params)
    if mesh is not None:
        params = shard_tree(params, built.in_shardings[0])
        opt_state = shard_tree(opt_state, built.in_shardings[1])

    def gathered():  # the whole state (every rank takes part), rank 0's to save
        if mesh is None:
            return state_arrays(params, opt_state)
        return state_arrays(full_tree(params), full_tree(opt_state))

    start_step = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and args.resume and ck.steps():
        like = state_arrays(params, opt_state)
        arrays, _, start_step = ck.restore(
            like, shardings=state_shardings(built.in_shardings) if mesh is not None else None,
            device=dev)
        params, opt_state = state_from_arrays(arrays, params, opt_state)
        say(f"[train] resumed from step {start_step}")

    cuda = dev.type == "cuda"
    losses, marks = [], []
    t0 = time.time()
    tokens_seen = 0
    for step in range(start_step, args.steps):
        raw = ds.batch(step, args.batch)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        if mesh is not None:
            batch = shard_tree(batch, built.in_shardings[2])
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
            m = {k: _host(v) for k, v in metrics.items()}
            say(f"[train] step {step:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                f"lr={m['lr']:.2e} tok/s={tokens_seen / (time.time() - t0):.0f}", flush=True)
        if ck and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            state = gathered()
            if lead:
                ck.save_async(step + 1, state, metadata={"arch": args.arch})
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    if ck:
        state = gathered()
        if lead:
            ck.wait()
            ck.save(args.steps, state, metadata={"arch": args.arch})
    say(f"[train] done in {seconds:.1f}s")
    step_ms = [s.elapsed_time(e) if cuda else (e - s) * 1e3 for s, e in marks]
    losses = [_host(x) for x in losses]
    return {"loss": losses[-1] if losses else None, "losses": losses, "step_ms": step_ms,
            "start_step": start_step, "steps": args.steps, "seconds": seconds,
            "tokens_per_s": tokens_seen / seconds if seconds > 0 else None}


def _host(v) -> float:
    """A metric's value on the host (a replicated DTensor's own copy)."""
    return float(v.full_tensor() if hasattr(v, "full_tensor") else v)


if __name__ == "__main__":
    main()
