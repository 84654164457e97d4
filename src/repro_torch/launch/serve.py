"""Serving: LM decode with continuous batching, and epidemiology forecast
queries (`--epi`). Counterpart of `repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \
        --device cpu --requests 8 --prompt-len 16 --gen 8

    # an MoE decoder, with the int8 KV cache
    REPRO_KV_QUANT=1 PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --smoke --device cpu

    # the state-space, hybrid and vision-language families
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --smoke --device cpu

    # answer forecast / counterfactual queries from cached SMC-ABC fits
    # (fitted on demand, through the abc_sim kernel on the card)
    PYTHONPATH=src python -m repro_torch.launch.serve --epi \
        --queries queries.json --store store/ --out responses.json

LM mode: a static batch of slots; requests are slotted in and out of it;
each slot advances at its own position, writing and attending its own cache
prefix, and a slot's cache lanes are zeroed when a request is admitted into
it (bf16 k and v, or under `REPRO_KV_QUANT=1` the int8 values and their
scales alike; the Mamba layers' float32 ssm state and bf16 conv rows of
mamba2-130m and zamba2-2.7b too). So batched outputs equal serving each
request alone, token for token.

Every arch of the port serves: the decoders (gemma-2b, gemma2-27b,
internlm2-20b, minitron-8b and the MoE ones), mamba2-130m (ssm),
zamba2-2.7b (hybrid: Mamba layers and a shared attention block with its own
KV rows at each of its sites) and internvl2-2b (vlm: served as its text
decoder, as `repro` serves it, with no image rows in the cache). The
encoder-decoder family is refused, as in `repro`.

The MoE archs (deepseek-moe-16b, qwen3-moe-30b-a3b) route the batch's
tokens of a step together: an expert holds C = max(8, ...) slots of the
step (`models.moe.capacity`), and a token picks top_k distinct experts, so
with at most 8 slots no expert overflows and the guarantee above holds. With
more slots (`--slots 16`) more than C tokens of one step may pick one
expert; the later ones are dropped from it, as `repro`'s serving loop drops
them too, and a request's tokens may then depend on the requests beside it.

`--epi` mode (`core.serving.EpiServer`): queries that share a forecast
shape are answered `--slots` lanes at a time in one batched call; the
posteriors come from memory, the `--store`, or an on-demand fit: SMC-ABC
waves, or with `--backend npe` a forward pass of an amortized estimator
(`core.npe`, trained on the first query of a model and kept beside the
store).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ioutils import atomic_write_text
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
    if model.family == "encdec":
        raise SystemExit("serve.py LM mode drives decoder-family archs")
    vocab = model.cfg.vocab if hasattr(model.cfg, "vocab") else model.cfg.lm.vocab
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


# ---------------------------------------------------------------- epi mode
def _load_queries(path: str):
    from repro_torch.core.serving import ForecastQuery

    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        raw = raw["queries"]
    if not isinstance(raw, list) or not raw:
        raise SystemExit(f"--queries {path!r}: expected a non-empty list")
    return [ForecastQuery.from_json(q) for q in raw]


def run_epi_cli(args):
    """Answer `--queries` with an `EpiServer` on `--device`; returns the
    number of responses."""
    from repro_torch.core.serving import EpiServer, ServeConfig
    from repro_torch.core.smc import SMCConfig

    if not args.queries:
        raise SystemExit("--epi requires --queries FILE.json")
    queries = _load_queries(args.queries)
    cfg = ServeConfig(
        slots=args.slots,
        forecast_particles=args.particles,
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
        data_dir=args.data_dir or None,
        store_dir=args.store or None,
        fit_backend=args.backend,
    )
    server = EpiServer(cfg, device=args.device)
    t0 = time.time()
    responses = server.answer(queries)
    stats = server.stats()
    stats["wall_time_s"] = time.time() - t0
    text = json.dumps(
        {"responses": responses, "stats": stats}, indent=1, allow_nan=False
    )
    if args.out:
        atomic_write_text(args.out, text)
        print(f"[serve] {len(responses)} responses saved to {args.out}",
              file=sys.stderr)
    else:
        print(text)
    print(
        f"[serve --epi] {len(responses)} queries, {stats['fits']} fits "
        f"({stats['warm_fits']} warm), {stats['npe_trains']} npe trains "
        f"({stats['npe_fine_tunes']} fine-tunes), "
        f"{stats['batched_calls']} batched "
        f"calls over {stats['compiled_shapes']} compiled shapes, "
        f"{stats['wall_time_s']:.2f}s",
        file=sys.stderr,
    )
    return len(responses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM architecture to serve (LM mode; registry name)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch slots (LM) / query lanes per batched call (--epi)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # epidemiology serving
    ap.add_argument("--epi", action="store_true",
                    help="serve epidemiology posterior queries instead of an LM: answer "
                         "a batch of forecast/counterfactual queries from cached SMC-ABC "
                         "posteriors")
    ap.add_argument("--queries", default="",
                    help="JSON file: list of query objects (dataset, model, horizon, "
                         "schedule, quantiles, seed), or {'queries': [...]}")
    ap.add_argument("--data-dir", default="",
                    help="directory of <name>.json dataset files (bundled registry "
                         "datasets resolve otherwise)")
    ap.add_argument("--store", default="",
                    help="posterior-store directory (persist fits across invocations; "
                         "the abc_serve daemon refreshes it)")
    ap.add_argument("--out", default="", help="response JSON path (default: stdout)")
    ap.add_argument("--particles", type=int, default=128,
                    help="posterior particles per forecast")
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
                    help="on-demand fit mechanism (--epi): SMC-ABC waves, or an "
                         "amortized NPE estimator (trained once, then forward passes)")
    ap.add_argument("--seed", type=int, default=0, help="fit seed (--epi)")
    args = ap.parse_args(argv)
    if args.epi:
        if args.arch:
            ap.error("--arch has no effect with --epi")
        return run_epi_cli(args)
    if not args.arch:
        ap.error("--arch is required (LM mode); or pass --epi")
    return run_lm_cli(args)


if __name__ == "__main__":
    main()
