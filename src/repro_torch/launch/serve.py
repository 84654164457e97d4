"""LM serving: a continuous-batching slot scheduler for decode.

Counterpart of `repro.launch.serve` (LM mode, `:42-153`):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \
        --device cpu --requests 8 --prompt-len 16 --gen 8

A static batch of slots; requests are slotted in and out of it; each slot
advances at its own position, writing and attending its own cache prefix,
and a slot's cache lanes are zeroed when a request is admitted into it. So
batched outputs equal serving each request alone, token for token.

Epidemiology mode (`--epi`) is not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model


def zero_slot(cache, logical, slot: int):
    """Zero one slot's lanes in every cache tensor, in place; returns the
    cache. A freed slot still holds the previous occupant's prefix; without
    this the next request admitted into it would attend over stale rows."""
    if set(cache) != set(logical):
        raise ValueError(f"cache keys {sorted(cache)} != logical keys {sorted(logical)}")
    for name, arr in cache.items():
        b = logical[name].index("batch")
        arr[(slice(None),) * b + (slot,)] = 0
    return cache


def run_lm_server(model, prompts, gen: int, slots: int, cache_len: int, *,
                  params=None, device="cuda"):
    """Continuous-batching greedy decode; returns (outputs, steps).

    `outputs[i]` is the generated token list of `prompts[i]`, in submission
    order. `params` defaults to `model.init_params()` from a generator
    seeded 0 on `device`.
    """
    device = resolve_device(device)
    logical = model.cache_logical()
    if params is None:
        params = model.init_params(device=device)
    cache = model.init_cache(slots, cache_len, device)

    queue = list(range(len(prompts)))
    outputs = [None] * len(prompts)
    slot_req = [None] * slots  # request index occupying each slot
    slot_pos = np.zeros(slots, np.int64)
    slot_out = [[] for _ in range(slots)]
    steps = 0
    while queue or any(r is not None for r in slot_req):
        for s in range(slots):
            if slot_req[s] is None and queue:
                slot_req[s] = queue.pop(0)
                slot_pos[s] = 0
                slot_out[s] = []
                zero_slot(cache, logical, s)
        toks = np.zeros((slots, 1), np.int64)
        for s, ri in enumerate(slot_req):
            if ri is None:
                continue
            p = int(slot_pos[s])
            if p < len(prompts[ri]):
                toks[s, 0] = prompts[ri][p]  # still consuming the prompt
            elif slot_out[s]:
                toks[s, 0] = slot_out[s][-1]
        # per-slot positions: each slot writes its next cache row
        batch = {"tokens": torch.as_tensor(toks, device=device),
                 "pos": torch.as_tensor(slot_pos, device=device)}
        logits, cache = model.decode_step(params, cache, batch)
        steps += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s, ri in enumerate(slot_req):
            if ri is None:
                continue
            slot_pos[s] += 1
            if slot_pos[s] >= len(prompts[ri]):
                slot_out[s].append(int(nxt[s]))
            if len(slot_out[s]) >= gen:
                outputs[ri] = slot_out[s]
                slot_req[s] = None
    return outputs, steps


def run_lm_cli(args) -> dict:
    """Serve `args.requests` random prompts; returns what it printed as a dict."""
    device = resolve_device(args.device)
    model = get_model(args.arch, smoke=args.smoke)
    vocab = model.cfg.vocab
    cache_len = args.prompt_len + args.gen
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, vocab, size=args.prompt_len).astype(np.int32).tolist()
        for _ in range(args.requests)
    ]
    params = model.init_params(device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outputs, steps = run_lm_server(model, prompts, args.gen, args.slots, cache_len,
                                   params=params, device=device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"[serve] {len(outputs)} requests, {steps} decode steps, "
          f"{steps * args.slots / dt:.1f} tok/s ({where})")
    for i, (req, out) in enumerate(zip(prompts, outputs)):
        if i >= 3:
            break
        print(f"  req{i}: prompt[:4]={req[:4]} -> gen={out}")
    return {"requests": len(outputs), "steps": steps, "seconds": dt,
            "tok_per_s": steps * args.slots / dt, "outputs": outputs, "device": where}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM architecture to serve (LM mode; registry name)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4, help="decode batch slots")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--epi", action="store_true",
                    help="epidemiology serving: not ported yet")
    args = ap.parse_args(argv)
    if args.epi:
        raise NotImplementedError("serve --epi is not yet ported to repro_torch; "
                                  "use repro.launch.serve --epi")
    if not args.arch:
        ap.error("--arch is required (LM mode)")
    return run_lm_cli(args)


if __name__ == "__main__":
    main()
