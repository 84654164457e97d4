"""qwen3-moe-30b-a3b's N-rank train, prefill and decode steps on 8 gloo
ranks laid out (2, 4), held against `repro`'s own sharded steps on a (2, 4)
host mesh (run in a subprocess with 8 forced host devices): a mesh with 2
data ranks makes its MoE `repro`'s G = 2 dispatch, which no single-device
step computes. The bars and the rank worker are tests/test_torch_steps_mesh.py's.

Routing flips are pinned as tests/test_torch_moe.py pins them: both
packages' routing is recorded at every MoE call of every phase (`repro`'s
through a `jax.debug.callback` on its real path, the port's through
`moe.route` on every rank); a flip must be explained by the difference of
the two router inputs, and the port then runs again with `repro`'s choice
at those tokens.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.distributed import spawn_ranks
from test_torch_steps_mesh import (DECODE, LEAF_STEPS, LR, PREFILL, SRC, TRAIN, _batch, _cache,
                                   _check_logits, _check_moments_halved, _check_train,
                                   _jax_leaves, _noise_f32, _np, _rank_steps, _step,
                                   _tree_unflatten)

torch.set_num_threads(1)


REPRO_QWEN3 = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_host_mesh, set_mesh_compat
from repro.launch.shapes import InputShape
from repro.launch.steps import build_decode_step, build_prefill_step, build_train_step
from repro.models.registry import get_model
from repro.optim import AdamWConfig, adamw_init

import repro.models.moe as jmoe

inputs = pickle.load(open(sys.argv[1], "rb"))
calls, phase, ffn = [], [None], jmoe.moe_ffn


def recorded(x, p, cfg, act="silu"):
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    ids = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], -1), cfg.top_k)[1]
    if phase[0] is not None:
        jax.debug.callback(lambda x_, r_, i_, ph=phase[0]: calls.append(
            (ph, np.asarray(x_), np.asarray(r_), np.asarray(i_))), xf, p["router"], ids)
    return ffn(x, p, cfg, act)


jmoe.moe_ffn = recorded
f32 = lambda t: jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), t)
jm = get_model("qwen3-moe-30b-a3b", smoke=True)
jp = jm.init_params(jax.random.PRNGKey(0))
out = {"params0": f32(jp)}
mesh = make_host_mesh(8, model=4)
with set_mesh_compat(mesh):
    built = build_train_step(jm, mesh, InputShape(*inputs["train_shape"]),
                             opt_cfg=AdamWConfig(**inputs["opt"]), donate=False,
                             microbatch=inputs["microbatch"])
    batch = jax.device_put({k: jnp.asarray(v) for k, v in inputs["train"].items()},
                           built.in_shardings[2])
    phase[0] = "train"
    p2, opt, met = built.fn(jax.device_put(jp, built.in_shardings[0]),
                            jax.device_put(adamw_init(jp), built.in_shardings[1]), batch)
    jax.effects_barrier()
    out.update(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               params=f32(p2), mu=f32(opt["mu"]), nu=f32(opt["nu"]))
    phase[0] = "prefill"
    pre = build_prefill_step(jm, mesh, InputShape(*inputs["prefill_shape"]))
    out["prefill"] = f32(pre.fn(jax.device_put(jp, pre.in_shardings[0]),
                                jax.device_put({k: jnp.asarray(v) for k, v in
                                                inputs["prefill"].items()}, pre.in_shardings[1])))
    jax.effects_barrier()
    phase[0] = "decode"
    dec = build_decode_step(jm, mesh, InputShape(*inputs["decode_shape"]))
    k, v = (jnp.asarray(inputs["cache"][n], jnp.bfloat16) for n in ("k", "v"))
    cache = {"layers": ((k, v),)}
    logits, cache = dec.fn(jax.device_put(jp, dec.in_shardings[0]),
                           jax.device_put(cache, dec.in_shardings[1]),
                           jax.device_put({k: jnp.asarray(v) for k, v in inputs["decode"].items()},
                                          dec.in_shardings[2]))
    out["decode"] = f32(logits)
    out["cache"] = {"k": f32(cache["layers"][0][0]), "v": f32(cache["layers"][0][1])}
jax.effects_barrier()
out["routing"] = calls
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def test_meshed_qwen3_matches_repro_sharded_steps(tmp_path):
    """qwen3-moe-30b-a3b on (2, 4): 2 data ranks make 2 dispatch groups, so
    the reference is `repro`'s own sharded steps (G = 2) on a (2, 4) host
    mesh, from `repro`'s parameters crossed through `convert`."""
    import pickle

    from repro_torch.convert import params_from_arrays, params_to_arrays
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import tree_leaves

    model = get_model("qwen3-moe-30b-a3b", smoke=True)
    assert model.cfg.attn_pattern == ("global",) and not model.cfg.n_dense_prefix
    cache = _cache(model)
    decode = _batch(model, "decode", DECODE[2], DECODE[3])
    inputs = {"train_shape": TRAIN, "prefill_shape": PREFILL, "decode_shape": DECODE,
              "opt": dict(lr=LR, warmup_steps=1, total_steps=10), "microbatch": 2,
              "train": {k: v.numpy() for k, v in _batch(model, "train", TRAIN[2],
                                                        TRAIN[3]).items()},
              "prefill": {k: v.numpy() for k, v in _batch(model, "prefill", PREFILL[2],
                                                          PREFILL[3]).items()},
              "decode": {"tokens": decode["tokens"].numpy(), "pos": np.asarray(5, np.int32)},
              "cache": {k: _np(v) for k, v in cache.items()}}
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", REPRO_QWEN3, str(tmp_path / "in.pkl"),
                          str(tmp_path / "out.pkl")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        want = pickle.load(f)

    tp = params_from_arrays(model, want["params0"])
    leaves = [_np(t) for t in tree_leaves(tp)]
    force = {}
    for _ in range(MAX_RUNS):
        ranks = spawn_ranks(_rank_steps, 8, "qwen3-moe-30b-a3b", leaves, 2, force,
                            device="cpu", timeout=240, tmp_dir=str(tmp_path))
        flips = _flips(want["routing"], ranks, model.cfg)
        if not flips:
            break
        for call, tokens in flips.items():
            force.setdefault(call, {}).update(tokens)
    else:
        raise AssertionError(f"routing still flips after {MAX_RUNS} runs: {force}")
    assert sum(len(t) for t in force.values()) <= MAX_FLIPS, force
    got = ranks[0]
    template = model.init_params(torch.Generator().manual_seed(0), device="cpu")

    def repro_layout(leaves):
        tree = _tree_unflatten(template, [torch.from_numpy(a) for a in leaves])
        return [np.asarray(a) for a in _jax_leaves(params_to_arrays(model, tree))]

    mine = dict(got, params=repro_layout(got["params"]), mu=repro_layout(got["mu"]),
                nu=repro_layout(got["nu"]))
    theirs = dict(want, params=_jax_leaves(want["params"]), mu=_jax_leaves(want["mu"]),
                  nu=_jax_leaves(want["nu"]))
    _check_train(mine, theirs, "qwen3-moe-30b-a3b", None, _jax_leaves(want["params0"]))
    _check_moments_halved(ranks, model)
    for what in ("prefill", "decode"):
        # the escape's noise: the port's own bf16 logits against its float32
        # ones on these parameters and inputs, on one device (one group)
        _check_logits(got[what], want[what], model.cfg,
                      lambda: _noise_f32(model, tp, what), what)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got["cache"][name][:, :, :5], want["cache"][name][:, :, :5])
        np.testing.assert_allclose(got["cache"][name], want["cache"][name], rtol=0,
                                   atol=LEAF_STEPS * _step(want["cache"][name]))


#: most routing flips the port may be forced to take, and most runs to
#: find them (each run forces every flip the last one showed)
MAX_FLIPS = 6
MAX_RUNS = 3


def _flips(repro_calls, ranks, cfg):
    """{(phase, call): {token: repro's ids}} of each phase's first MoE call
    (train: a layer of a microbatch; prefill; decode) where the port chose
    other experts than `repro`: later calls of that phase see the flip's
    effect, and the phases start apart from the same parameters. Each flip
    must be explained by the difference of the two router inputs (the logit
    gap within sum_i |dx_i| (|R_ia| + |R_ib|)), as tests/test_torch_moe.py
    explains one; the port then takes `repro`'s choice there. The calls up
    to it must line up: the two router inputs agree to bf16 noise."""
    port = {}
    for r in ranks:  # every model rank of a group routes alike: take each group once
        for ph, first, x, ids in r["routing"]:
            port.setdefault(ph, {}).setdefault(first, []).append((x, ids))
    counts, out = {}, {}
    for ph, jx, router, jids in repro_calls:
        call = counts.get(ph, 0)
        counts[ph] = call + 1
        if any(p == ph for p, _ in out):
            continue
        tx = np.concatenate([port[ph][f][call][0] for f in sorted(port[ph])])
        tids = np.concatenate([port[ph][f][call][1] for f in sorted(port[ph])])
        assert tx.shape == jx.shape and np.abs(tx - jx).max() <= 0.05 * np.abs(jx).max(), (
            ph, call, float(np.abs(tx - jx).max()))
        tokens = np.nonzero((np.sort(jids, -1) != np.sort(tids, -1)).any(-1))[0]
        for t in tokens:
            logits = jx[t].astype(np.float64) @ router.astype(np.float64)
            slack = np.abs(jx[t] - tx[t]).astype(np.float64) @ np.abs(router)
            for a in set(jids[t]) - set(tids[t]):
                for b in set(tids[t]) - set(jids[t]):
                    gap, bound = logits[a] - logits[b], slack[a] + slack[b] + 1e-5
                    assert gap <= bound, (
                        f"{ph} MoE call {call}, token {t}: repro routes to {a}, the port to "
                        f"{b}; their logit gap {gap:.3g} exceeds what the router inputs' "
                        f"difference explains ({bound:.3g})")
                    print(f"routing flip in {ph} at MoE call {call}, token {t}: repro {a}, "
                          f"port {b}, logit gap {gap:.3g} <= {bound:.3g}")
        if len(tokens):
            out[(ph, call)] = {int(t): jids[t].tolist() for t in tokens}
    return out
