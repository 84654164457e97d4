"""The N-rank train, prefill and decode steps (`launch.steps` with a mesh)
on 8 gloo ranks laid out (2, 4) ("data", "model"), as
tests/test_steps_multidevice.py runs `repro`'s on 8 host devices.

gemma2-27b and mamba2-130m (smoke) are held against the port's own
single-device steps on the same parameters and batch, the train step with
microbatch 2; qwen3-moe-30b-a3b is held against `repro`'s sharded steps in
tests/test_torch_steps_mesh_moe.py, with this file's worker and bars.
Bars:
  * the loss at rtol 1e-3, the global norm at rtol 1e-2;
  * each first moment leaf (the clipped gradient times 1 - b1) within 8
    bf16 steps of its largest |value| (a sharded product adds its partial
    sums in another order, and rounds them to bf16 apart: bitwise equality
    is not expected); where a leaf misses that, within 8 steps plus half
    the reference's own bf16 noise there (its bf16 gradient against the
    float32 one of the same parameters widened, `common.DEFAULT_DTYPE`
    float32), as tests/test_torch_train_families.py bars a noisy leaf
    (mamba2's D: a sum over the batch of products that nearly cancel);
  * each second moment, read as the |gradient| it holds, at the first
    moment's bar;
  * each parameter's change in the step against the reference's change:
    AdamW's first step is lr (g / (|g| + eps) + wd p), so where the
    reference's first moment exceeds the two moments' difference (the
    gradient's sign is decided) and both gradients exceed 1000 eps, the
    two changes are equal but for lr eps / min |g| and one bf16 rounding
    of the new value; where neither side has a gradient they are equal
    but for that rounding. At least 90% of the parameters are held so
    (the rest are listed), and at most 1% of those differ at all. A step
    that hands back stale, shifted or sign-flipped blocks fails this;
  * prefill and decode logits within tests/test_torch_lm.py's bf16 bar (4
    steps at the largest |logit|, 8 with a Python-float query scale), or,
    where they miss it, within that bar plus half the reference's own bf16
    noise (its logits against the float32 ones), the escape the gradients
    have: a row-parallel product ("model" splitting its contraction, as
    the Mamba out_proj) rounds each rank's partial sum to bf16 before the
    all-reduce adds them, as GSPMD's does in `repro`.
Each rank's AdamW moments hold 1/2 of the whole along "embed" where the
data axis divides it (ZeRO-1), and the decode cache written in place by
the rank that holds the position.

The rank workers are module-level functions (spawn imports this file in
each child; it imports no `jax` at module level).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import spawn_ranks

torch.set_num_threads(1)

MESH = (2, 4)
LOSS_RTOL = 1e-3
NORM_RTOL = 1e-2
LEAF_STEPS = 8
LR = 1e-3
B1, B2, EPS = 0.9, 0.95, 1e-8  # AdamWConfig's
#: the least share of parameters whose update is held to the reference's,
#: and the most share of those whose update may be a bf16 step apart
MIN_DECIDED = 0.9
MAX_ROUNDED = 0.01
TRAIN = ("t", "train", 16, 8)  # name, mode, seq, batch
PREFILL = ("p", "prefill", 16, 8)
DECODE = ("d", "decode", 16, 8)
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _step(a) -> float:
    top = float(np.abs(a).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _logits_bar(want, cfg) -> float:
    steps = 4 if getattr(cfg, "query_scale", None) is None else 8
    return steps * _step(want)


def _batch(model, mode, seq, batch, seed=1):
    return model.example_inputs(mode, batch, seq, "cpu", seed=seed)


def _leaves_np(tree):
    from repro_torch.launch.steps import full_tree
    from repro_torch.optim.adamw import tree_leaves

    return [_np(t) for t in tree_leaves(full_tree(tree))]


class _Routing:
    """The port's routing at each MoE call of each phase, by global token
    (this rank's group of the batch, or of the microbatch), taking `force`'s
    experts ({(phase, call): {token: ids}}) where given."""

    def __init__(self, force):
        from repro_torch.models import moe

        self.force, self.calls, self.phase, self.route = force or {}, [], None, moe.route
        self.select = moe.select_experts

    def __call__(self, xf, router, cfg, c):
        from repro_torch.launch.mesh import ambient_mesh
        from repro_torch.models import moe

        mesh = ambient_mesh()
        group = 0
        for i, a in enumerate(mesh.mesh_dim_names):
            if a in ("pod", "data"):
                group = group * mesh.size(i) + mesh.get_coordinate()[i]
        first = group * xf.shape[0]
        call = sum(1 for c_ in self.calls if c_[0] == self.phase)
        forced = {t - first: ids for t, ids in self.force.get((self.phase, call), {}).items()
                  if first <= t < first + xf.shape[0]}

        def pick(probs, k_):
            w, ids = self.select(probs, k_)
            w, ids = w.clone(), ids.clone()
            for t, want in forced.items():
                ids[t] = torch.as_tensor(want)
                w[t] = probs[t, ids[t]] / probs[t, ids[t]].sum()
            return w, ids

        moe.select_experts = pick
        try:
            r = self.route(xf, router, cfg, c)
        finally:
            moe.select_experts = self.select
        if self.phase is not None:
            self.calls.append((self.phase, first, _np(xf), r.top_ids.numpy()))
        return r


def _rank_steps(rank, n, arch, params_np, microbatch, force=None):
    """One rank: the meshed train step (from `params_np` when given, else
    the port's seed-0 parameters), prefill and decode. Returns full arrays
    on rank 0 and the shapes of this rank's moment shards on every rank;
    for an MoE, each rank's routing in each phase (`_Routing`)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_step, full_tree, shard_tree
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    routing = _Routing(force)
    moe.route = routing
    mesh = make_host_mesh(n, model=MESH[1])
    model = get_model(arch, smoke=True)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    if params_np is not None:
        params = tree_unflatten(params, [torch.from_numpy(a).to(t.dtype) for a, t in
                                         zip(params_np, tree_leaves(params))])
    out = {}
    routing.phase = "train"
    built = build_step(model, InputShape(*TRAIN), mesh,
                       opt_cfg=AdamWConfig(lr=LR, warmup_steps=1, total_steps=10),
                       microbatch=microbatch)
    p_sh, o_sh, b_sh = built.in_shardings
    dp = shard_tree(params, p_sh)
    dopt = shard_tree(adamw_init(params), o_sh)
    batch = shard_tree(_batch(model, "train", TRAIN[2], TRAIN[3]), b_sh)
    dp, dopt, met = built.fn(dp, dopt, batch)
    out["loss"] = float(met["loss"].full_tensor())
    out["grad_norm"] = float(met["grad_norm"].full_tensor())
    out["params"] = _leaves_np(dp)
    out["mu"] = _leaves_np(dopt["mu"])
    out["nu"] = _leaves_np(dopt["nu"])
    out["mu_local"] = [tuple(t.to_local().shape) for t in tree_leaves(dopt["mu"])]
    out["mu_spec"] = [s.spec for s in tree_leaves(o_sh["mu"])]

    routing.phase = "prefill"
    pre = build_step(model, InputShape(*PREFILL), mesh)
    pp = shard_tree(params, pre.in_shardings[0])
    logits = pre.fn(pp, shard_tree(_batch(model, "prefill", PREFILL[2], PREFILL[3]),
                                   pre.in_shardings[1]))
    out["prefill"] = _np(logits.full_tensor())

    routing.phase = "decode"
    dec = build_step(model, InputShape(*DECODE), mesh)
    cache = _cache(model)
    dcache = shard_tree(cache, dec.in_shardings[1])
    dbatch = shard_tree(_batch(model, "decode", DECODE[2], DECODE[3]), dec.in_shardings[2])
    dbatch["pos"] = shard_tree({"pos": torch.tensor(5, dtype=torch.int32)},
                               {"pos": dec.in_shardings[2]["pos"]})["pos"]
    logits, dcache = dec.fn(pp, dcache, dbatch)
    out["decode"] = _np(logits.full_tensor())
    out["cache"] = {k: _np(v) for k, v in full_tree(dcache).items()}
    out["cache_local"] = {k: tuple(v.to_local().shape) for k, v in dcache.items()}
    out["routing"] = routing.calls
    return out if rank == 0 else {k: out[k] for k in ("mu_local", "cache_local", "routing")}


def _cache(model):
    """A decode cache of random values (a filled prefix), from numpy."""
    rng = np.random.default_rng(3)
    out = {}
    for name, s in model.init_cache_shape(DECODE[3], DECODE[2]).items():
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.5
        out[name] = torch.from_numpy(a).to(s.dtype)
    return out


def _check_logits(got, want, cfg, noise_f32, what):
    """Within the logit bar, or within it plus half the bf16 noise
    `noise_f32()` (float32 logits less bf16 ones) where it is missed."""
    bar, diff = _logits_bar(want, cfg), float(np.abs(got - want).max())
    if diff <= bar:
        return
    noise = float(np.abs(noise_f32()).max())
    assert diff <= bar + noise / 2, (
        f"{what}: {diff / _step(want):.1f} bf16 steps from the reference, whose own bf16 "
        f"logits are {noise / _step(want):.1f} steps from its float32 ones")


def _single_device(arch, microbatch=2, f32=False):
    """The port's single-device steps on the same inputs (the serving ones
    only with `f32`: the parameters widened to float32 and
    `common.DEFAULT_DTYPE` float32)."""
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map

    model = get_model(arch, smoke=True)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    if f32:
        keep = cm.DEFAULT_DTYPE
        cm.DEFAULT_DTYPE = torch.float32
        try:
            return model, _serve(model, tree_map(lambda t: t.to(torch.float32), params),
                                 torch.float32)
        finally:
            cm.DEFAULT_DTYPE = keep
    built = build_step(model, InputShape(*TRAIN),
                       opt_cfg=AdamWConfig(lr=LR, warmup_steps=1, total_steps=10),
                       microbatch=microbatch, donate=False)
    params0 = [_np(t) for t in tree_leaves(params)]
    p2, opt, met = built.fn(params, adamw_init(params), _batch(model, "train", TRAIN[2], TRAIN[3]))
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "params0": params0, "params": [_np(t) for t in tree_leaves(p2)],
           "mu": [_np(t) for t in tree_leaves(opt["mu"])],
           "nu": [_np(t) for t in tree_leaves(opt["nu"])]}
    out.update(_serve(model, params))
    return model, out


def _noise_f32(model, params, what):
    """`what`'s logits of the port on one device in float32 (parameters
    widened, `common.DEFAULT_DTYPE` float32) less its bf16 ones, plus the
    bf16 ones: a stand-in for the reference's float32 logits whose distance
    from the bf16 ones is the port's own bf16 noise there."""
    from repro_torch.models import common as cm
    from repro_torch.optim.adamw import tree_map

    bf16 = _serve(model, params)[what]
    keep = cm.DEFAULT_DTYPE
    cm.DEFAULT_DTYPE = torch.float32
    try:
        f32 = _serve(model, tree_map(lambda t: t.to(torch.float32), params),
                     torch.float32)[what]
    finally:
        cm.DEFAULT_DTYPE = keep
    return f32 - bf16


def _serve(model, params, dtype=None):
    """Prefill and one decode step on one device, the float inputs cast to
    `dtype` when given."""
    def cast(batch):
        return {k: v.to(dtype) if dtype is not None and v.is_floating_point() else v
                for k, v in batch.items()}

    out = {"prefill": _np(model.prefill(params, cast(_batch(model, "prefill", PREFILL[2],
                                                             PREFILL[3]))))}
    cache = cast(_cache(model))
    batch = _batch(model, "decode", DECODE[2], DECODE[3])
    batch["pos"] = torch.tensor(5, dtype=torch.int32)
    logits, cache = model.decode_step(params, cache, batch)
    out["decode"], out["cache"] = _np(logits), {k: _np(v) for k, v in cache.items()}
    return out


def _f32_first_moments(model, grad_norm, batch, params=None):
    """(1 - b1) times the clipped float32 gradient of the parameters widened
    to float32, `common.DEFAULT_DTYPE` float32: the bf16 reference's noise
    floor."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import common as cm
    from repro_torch.optim.adamw import tree_leaves, tree_map

    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    params = tree_map(lambda t: t.to(torch.float32), params)
    keep = cm.DEFAULT_DTYPE
    cm.DEFAULT_DTYPE = torch.float32
    try:
        batch = {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in batch.items()}
        _, grads = value_and_grad(model, params, batch)
    finally:
        cm.DEFAULT_DTYPE = keep
    scale = (1 - 0.9) * min(1.0, 1.0 / grad_norm)
    return [_np(g) * scale for g in tree_leaves(grads)]


def _check_train(got, want, what, f32_moments, params0):
    """The loss, the global norm, both moments and the update (see the
    module docstring); `params0` the leaves both steps started from."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL,
                               err_msg=what)
    n = len(got["params"])
    assert len(got["mu"]) == len(want["mu"]) == len(got["nu"]) == len(want["nu"]) == n
    assert len(want["params"]) == len(params0) == n
    f32 = None
    decided = rounded = total = 0
    undecided = []
    for i in range(n):
        g, w = got["mu"][i], want["mu"][i]
        step, diff = _step(w), float(np.abs(g - w).max())
        bar = LEAF_STEPS * step
        if diff > bar:
            f32 = f32_moments() if f32 is None else f32
            noise = float(np.abs(w - f32[i]).max())
            assert diff <= bar + noise / 2, (
                f"{what} mu leaf {i}: {diff / step:.1f} bf16 steps from the reference, whose "
                f"own bf16 moment is {noise / step:.1f} steps from its float32 one")
            bar += noise / 2
        # the second moment, as the |gradient| it holds, at the first's bar
        held = [np.sqrt(t["nu"][i].astype(np.float64) / (1 - B2)) * (1 - B1) for t in (got, want)]
        nu_diff = float(np.abs(held[0] - held[1]).max())
        assert nu_diff <= bar, (f"{what} nu leaf {i}: its |gradient| {nu_diff / step:.1f} bf16 "
                                f"steps from the reference's (bar {bar / step:.1f})")
        # the update, where the reference's gradient decides its sign and
        # both gradients are large enough beside eps to fix its size: a
        # first step is lr (gs / (|gs| + eps) + wd p), gs the clipped
        # gradient, so the two updates part by at most lr eps / min |gs|
        # (1e-3 lr here) before the bf16 rounding, which may part them by
        # one step; and where neither side has a gradient (a token the
        # batch does not hold), the update is the weight decay alone
        gs = np.minimum(np.abs(g), np.abs(w)).astype(np.float64) / (1 - B1)
        sure = (np.abs(w) > np.abs(g - w)) & (gs > 1e3 * EPS)
        sure_slack = LR * EPS / np.where(sure, gs, np.inf)
        sure |= (g == 0) & (w == 0)
        moved = got["params"][i] - params0[i], want["params"][i] - params0[i]
        off = sure & (moved[0] != moved[1])
        apart = np.abs(moved[0] - moved[1])
        one = _bf16_step(np.maximum(np.abs(got["params"][i]), np.abs(want["params"][i])))
        assert not (off & (apart > one + sure_slack)).any(), (
            f"{what} leaf {i}: updates more than a bf16 step from the reference's where its "
            f"gradient decides their sign, e.g. {moved[0][off][:4].tolist()} against "
            f"{moved[1][off][:4].tolist()}")
        decided += int(sure.sum())
        rounded += int(off.sum())
        total += sure.size
        if not sure.all():
            undecided.append((i, int((~sure).sum()), sure.size))
    print(f"{what}: the update is held to the reference's at {decided} of {total} "
          f"parameters, {rounded} of them within the slack but not equal; (leaf, undecided, "
          f"size): {undecided}")
    assert decided >= MIN_DECIDED * total, (what, decided, total, undecided)
    assert rounded <= MAX_ROUNDED * decided, (what, rounded, decided)


def _bf16_step(a):
    """The bf16 step (unit in the last place) at each |value| of `a`, 0 at 0."""
    m, e = np.frexp(a.astype(np.float64))
    return np.where(a != 0, np.ldexp(1.0, e - 8), 0.0)


def _check_moments_halved(ranks, model):
    """ZeRO-1: a moment whose "embed" dim the data axis divides holds half
    of it on each rank, beside the "model" shards of the parameter's own
    layout."""
    full = [tuple(t.shape) for t in _tree_leaves(model.param_shapes())]
    spec0 = ranks[0]["mu_spec"] if "mu_spec" in ranks[0] else None
    halved = 0
    for r in ranks:
        for shape, local, spec in zip(full, r["mu_local"], spec0):
            for whole, part, entry in zip(shape, local, spec):
                axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
                k = (2 if "data" in axes else 1) * (4 if "model" in axes else 1)
                assert part * k == whole, (shape, local, spec)
                halved += "data" in axes
    assert halved > 0


def _tree_leaves(tree):
    from repro_torch.optim.adamw import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-130m"])
def test_meshed_steps_match_the_single_device_steps(arch, tmp_path):
    ranks = spawn_ranks(_rank_steps, 8, arch, None, 2, device="cpu", timeout=240,
                        tmp_dir=str(tmp_path))
    model, want = _single_device(arch)
    got = ranks[0]
    batch = _batch(model, "train", TRAIN[2], TRAIN[3])
    _check_train(got, want, arch, lambda: _f32_first_moments(model, want["grad_norm"], batch),
                 want["params0"])
    _check_moments_halved(ranks, model)
    for what in ("prefill", "decode"):
        _check_logits(got[what], want[what], model.cfg,
                      lambda: _single_device(arch, f32=True)[1][what] - want[what], what)
    for name, w in want["cache"].items():
        np.testing.assert_allclose(got["cache"][name], w, rtol=0,
                                   atol=LEAF_STEPS * _step(w), err_msg=name)


def _tree_unflatten(like, leaves):
    from repro_torch.optim.adamw import tree_unflatten

    return tree_unflatten(like, leaves)


def _jax_leaves(tree):
    """Leaves in `jax.tree.leaves` order (dict keys sorted), without jax."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _jax_leaves(t)]
    return [np.asarray(tree, np.float32)]

