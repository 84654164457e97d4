"""The port's MoE decoders, dense prefix layers and int8 KV cache on the CPU,
held against `repro`.

The MoE layer takes `repro`'s parameters (`init_moe(PRNGKey(s))`, router
float32, experts bf16, crossed as exact float32 copies) and seeded numpy
inputs; the deepseek-moe-16b and qwen3-moe-30b-a3b smoke models take
`repro`'s `init_params(PRNGKey(0))` through `convert`.

Bars, and why:
  * `moe_ffn` / `moe_ffn_global` against `jax.jit` of `repro`'s (how `repro`
    runs them): `top_ids` and the drop mask equal; y at rtol 1/128 and atol
    1e-5 (both round once from float32 sums; they may land one bf16 step
    apart where the float32 sums are taken in another order); the aux loss
    at rtol 1e-5 (float32 means in another order). With shared experts y is
    a bf16 sum of the routed and the shared output, each rounded on its
    own: one step of an addend moves y by up to 2^-7 of that addend, which
    is more than 2^-7 |y| where the two nearly cancel, so the bar adds
    |shared| / 128.
  * the cases of tests/test_moe.py: their own bars (rtol 0.08, atol 0.05
    against the dense oracle and between the two dispatch forms).
  * whole models: the logit bar of tests/test_torch_lm.py (4 bf16 steps at
    the largest |logit|); the argmax equal on every row whose top two
    logits are more than twice that bar apart (the logits are rounded to
    bf16, and closer rows, exact ties among them, have no decided choice
    at the bar's precision); served tokens equal, where a step whose
    choice is such a near-tie takes repro's token and is named.

Routing flips. Top-k is a discrete choice: where a token's k-th and
(k+1)-th router logits are closer than a one-ulp difference of the router
input can move them, the two packages may pick different experts. Every
whole-model run records both packages' routing at every MoE layer (`repro`'s
through a `jax.debug.callback` on its real path). A flip fails the test
unless the measured difference of the two router inputs explains it (the
logit gap is within sum_i |dx_i| (|R_ia| + |R_ib|)); an explained flip is
named (layer, step and token, with its gap) and the port is run again
with `repro`'s choice at that token (`run_matched`, first flip first, at
most MAX_FLIPS), and that run must meet the bars.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.mesh import make_host_mesh, set_mesh_compat
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models.registry import get_model as jget_model
from repro_torch.convert import decoder_params_from_arrays
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcm
from repro_torch.models import decoder as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_model, list_archs

torch.set_num_threads(1)

BF16 = dict(rtol=1 / 128, atol=1e-5)
ORACLE = dict(rtol=0.08, atol=0.05)  # tests/test_moe.py's bar
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
IMPLS = ["dense", "flash", "blockwise", "auto"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _close_moe(got, want, x, p, cfg):
    """`_close` at the bf16 bar, plus |shared| / 128 with shared experts."""
    shared = 0.0
    if cfg.n_shared:
        shared = np.abs(_np(tcm.gated_mlp(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])))
    err, want = np.abs(_np(got) - _np(want)), np.abs(_np(want))
    bad = err > BF16["atol"] + BF16["rtol"] * (want + shared)
    assert not bad.any(), (f"{int(bad.sum())}/{bad.size} outside the bar; worst |diff| "
                           f"{float(err.max())}")


def _torch_moe_params(p):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16) for k, v in p.items()}


def _configs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _layer(e=8, k=2, d=32, f=16, n_shared=0, cf=1.25, seed=0, b=2, s=16, scale=0.5):
    """repro's and the port's config, parameters and input of one MoE layer."""
    jcfg, tcfg = _configs(n_experts=e, top_k=k, d_expert=f, n_shared=n_shared,
                          capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, jcfg)
    x = (np.random.default_rng(seed + 1).standard_normal((b, s, d)) * scale).astype(np.float32)
    return (jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16),
            tcfg, _torch_moe_params(jp), torch.from_numpy(x).to(torch.bfloat16))


def _repro_routing(x, p, cfg):
    """repro's top_ids, k-th minus (k+1)-th probability and keep mask, from
    the formulas of repro/models/moe.py (router, top_k, cumsum position)."""
    @jax.jit
    def fn(x):
        n = x.shape[0] * x.shape[1]
        probs = jax.nn.softmax(x.reshape(n, -1).astype(jnp.float32) @ p["router"], -1)
        top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
        ids = jax.lax.top_k(probs, cfg.top_k)[1]
        flat = ids.reshape(-1)
        oh = jax.nn.one_hot(flat, cfg.n_experts, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, flat[:, None], 1)[:, 0]
        return ids, top[:, -2] - top[:, -1], pos < jmoe.capacity(n, cfg)

    ids, gap, keep = fn(x)
    return np.asarray(ids), np.asarray(gap), np.asarray(keep)


#: (e, k, d, f, n_shared): tests/test_moe.py's layer, with shared experts, and
#: the MoE layers of the two smoke configs
LAYERS = {"test_moe": (8, 2, 32, 16, 0), "shared": (8, 2, 32, 16, 2),
          "deepseek-smoke": (8, 2, 64, 32, 2), "qwen3-smoke": (8, 2, 64, 32, 0),
          "k6-of-16": (16, 6, 32, 16, 1)}


# ------------------------------------------------------------------ the layer
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("form", ["grouped", "global"])
@pytest.mark.parametrize("layer", LAYERS)
def test_moe_ffn_matches_jitted_repro(layer, form, cf):
    e, k, d, f, n_shared = LAYERS[layer]
    jcfg, jp, jx, tcfg, tp, tx = _layer(e, k, d, f, n_shared, cf=cf, seed=len(layer))
    jfn, tfn = ((jmoe.moe_ffn, tmoe.moe_ffn) if form == "grouped" else
                (jmoe.moe_ffn_global, tmoe.moe_ffn_global))
    want, want_aux = jax.jit(lambda x, p: jfn(x, p, jcfg))(jx, jp)
    got, aux = tfn(tx, tp, tcfg)
    ids, gap, keep = _repro_routing(jx, jp, jcfg)
    c = tmoe.capacity(tx.shape[0] * tx.shape[1], tcfg)
    r = tmoe.route(tx.reshape(-1, d), tp["router"], tcfg, c)
    np.testing.assert_array_equal(r.top_ids.numpy(), ids,
                                  err_msg=f"smallest top-k gap {gap.min():.3g}")
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf < 1:
        assert not keep.all()  # the case drops slots
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close_moe(got, want, tx, tp, tcfg)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_position_in_expert_is_the_one_hot_cumsum():
    """The stable sort gives repro's cumulative-sum positions, skewed and
    uniform, every slot on one expert, and a single slot."""
    rng = np.random.default_rng(4)
    cases = [rng.integers(0, 8, 200), rng.integers(0, 128, 4096),
             np.minimum(rng.geometric(0.3, 3000) - 1, 63), np.zeros(50, np.int64),
             np.array([5])]
    for ids, e in zip(cases, (8, 128, 64, 4, 8)):
        oh = jax.nn.one_hot(jnp.asarray(ids), e, dtype=jnp.int32)
        want = np.asarray(jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1,
                                              jnp.asarray(ids)[:, None], 1)[:, 0])
        got = tmoe.position_in_expert(torch.as_tensor(ids, dtype=torch.long), e)
        np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_matches_repro(monkeypatch):
    for e, k, cf in ((64, 6, 1.25), (128, 8, 1.25), (8, 2, 0.25), (4, 2, 8.0)):
        jcfg, tcfg = _configs(n_experts=e, top_k=k, d_expert=8, capacity_factor=cf)
        for n in (1, 4, 8, 31, 2048, 8192):
            assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg)
    # the sizes of the two full configs' prefill (4 x 2048) and decode (4 slots)
    assert tmoe.capacity(8192, _configs(n_experts=64, top_k=6, d_expert=8)[1]) == 960
    assert tmoe.capacity(8192, _configs(n_experts=128, top_k=8, d_expert=8)[1]) == 640
    assert tmoe.capacity(4, _configs(n_experts=128, top_k=8, d_expert=8)[1]) == 8
    monkeypatch.setenv("REPRO_MOE_CF", "0.5")
    jcfg, tcfg = _configs(n_experts=64, top_k=6, d_expert=8)
    assert tmoe.capacity(8192, tcfg) == jmoe.capacity(8192, jcfg) == 384


@pytest.mark.parametrize("env", [{"REPRO_MOE_CF": "0.5"}, {"REPRO_MOE_GROUPED": "0"},
                                 {"REPRO_MOE_CF": "0.3", "REPRO_MOE_GROUPED": "0"}],
                         ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
def test_environment_switches_match_repro(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jcfg, jp, jx, tcfg, tp, tx = _layer(16, 4, 32, 16, 1, seed=11, s=24)
    want, want_aux = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jcfg))(jx, jp)
    got, aux = tmoe.moe_ffn(tx, tp, tcfg)
    _close_moe(got, want, tx, tp, tcfg)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # the switch takes the global form: the same bits as calling it directly
    if env.get("REPRO_MOE_GROUPED") == "0":
        assert torch.equal(got, tmoe.moe_ffn_global(tx, tp, tcfg)[0])
    _, _, keep = _repro_routing(jx, jp, jcfg)
    if "REPRO_MOE_CF" in env:
        assert not keep.all()


# ---------------------------------------- mirrors of tests/test_moe.py's cases
def _oracle_layer(e=8, k=2, d=32, f=16, n_shared=0, seed=0):
    """tests/test_moe.py's _setup: ample capacity (factor 8), x ~ 0.3 N(0, 1)."""
    jcfg, tcfg = _configs(n_experts=e, top_k=k, d_expert=f, n_shared=n_shared,
                          capacity_factor=8.0)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, jcfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (2, 16, d), jnp.float32) * 0.3
    x = x.astype(jnp.bfloat16)
    return jcfg, jp, x, tcfg, _torch_moe_params(jp), torch.from_numpy(_np(x).copy()).bfloat16()


def test_grouped_matches_dense_oracle():
    from test_moe import _dense_oracle

    jcfg, jp, jx, tcfg, tp, tx = _oracle_layer()
    y, aux = tmoe.moe_ffn(tx, tp, tcfg)
    _close(y, _dense_oracle(jx, jp, jcfg), ORACLE)
    _close(y, tmoe.dense_reference(tx, tp, tcfg), ORACLE)
    assert float(aux) >= 0
    # the port's oracle is repro's test oracle
    _close(tmoe.dense_reference(tx, tp, tcfg), _dense_oracle(jx, jp, jcfg), BF16)


def test_grouped_matches_global_formulation():
    _, _, _, tcfg, tp, tx = _oracle_layer(seed=3)
    _close(tmoe.moe_ffn(tx, tp, tcfg)[0], tmoe.moe_ffn_global(tx, tp, tcfg)[0], ORACLE)


def test_shared_experts_added():
    """With shared experts, y is the routed output plus the shared gated MLP,
    added in bf16, and equal to repro's."""
    jcfg, jp, jx, tcfg, tp, tx = _oracle_layer(n_shared=2, seed=5)
    y, _ = tmoe.moe_ffn(tx, tp, tcfg)
    assert y.shape == tx.shape and bool(torch.isfinite(y.float()).all())
    routed_cfg = dataclasses.replace(tcfg, n_shared=0)
    routed, _ = tmoe.moe_ffn(tx, {k: v for k, v in tp.items() if not k.startswith("shared")},
                             routed_cfg)
    shared = tcm.gated_mlp(tx, tp["shared_wg"], tp["shared_wu"], tp["shared_wd"])
    assert torch.equal(y, routed + shared)
    _close_moe(y, jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jcfg))(jx, jp)[0], tx, tp, tcfg)


def test_capacity_drops_tokens_not_correctness():
    """A capacity factor of 0.25 drops slots (repro's keep mask exactly); the
    dropped slots add zeros, and ample capacity gives at least the mass."""
    jcfg, tcfg = _configs(n_experts=4, top_k=2, d_expert=8, capacity_factor=0.25)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 16, jcfg)
    jx = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 16), jnp.bfloat16)
    tp, tx = _torch_moe_params(jp), torch.from_numpy(_np(jx).copy()).bfloat16()
    y, _ = tmoe.moe_ffn(tx, tp, tcfg)
    assert bool(torch.isfinite(y.float()).all())
    r = tmoe.route(tx.reshape(32, 16), tp["router"], tcfg, tmoe.capacity(32, tcfg))
    _, _, keep = _repro_routing(jx, jp, jcfg)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert 0 < int((~r.keep).sum()) < r.keep.numel()
    _close(y, jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jcfg))(jx, jp)[0], BF16)
    # tokens whose slots were all dropped come out exactly zero
    dropped_all = (~r.keep.reshape(32, 2)).all(-1)
    assert dropped_all.any() and bool((y[0, dropped_all] == 0).all())
    y2, _ = tmoe.moe_ffn(tx, tp, dataclasses.replace(tcfg, capacity_factor=8.0))
    assert float(y2.float().abs().sum()) >= float(y.float().abs().sum()) - 1e-3


def test_aux_loss_penalizes_imbalance():
    """Near-uniform routing gives about the minimum aux value (the weight)."""
    _, _, _, tcfg, tp, tx = _oracle_layer(e=4, k=1, seed=7)
    _, aux = tmoe.moe_ffn(tx, tp, tcfg)
    assert 0.5 * tcfg.router_aux_weight < float(aux) < 6 * tcfg.router_aux_weight
    # all slots on one expert: f = (1, 0, 0, 0), so aux = w E p_0
    r = tmoe.route(tx.reshape(32, -1), tp["router"], tcfg, 64)
    skewed = r._replace(top_ids=torch.zeros_like(r.top_ids))
    want = tcfg.router_aux_weight * 4 * float(r.probs[:, 0].mean())
    np.testing.assert_allclose(float(tmoe.aux_loss(skewed, tcfg)), want, rtol=1e-6)


def test_moe_params_and_logical_mirror_repro():
    jcfg, tcfg = _configs(n_experts=8, top_k=2, d_expert=16, n_shared=2)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), 32, tcfg)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 32, jcfg)
    assert tmoe.moe_logical(tcfg) == jmoe.moe_logical(jcfg)
    assert sorted(tp) == sorted(jp)
    for name, t in tp.items():
        assert tuple(t.shape) == jp[name].shape
        assert t.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
    assert [f.name for f in dataclasses.fields(tcfg)] == [
        f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


# -------------------------------------------------------------- int8 KV cache
def test_kv_quantize_bitwise_repro():
    """Bitwise `jax.jit(kv_quantize)`, as repro's decode runs it: compiled, the
    division by 127 is a product with float32 1/127 fused with the add of
    1e-12 (eager JAX divides, and its scales differ in the last bit)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-12, values 0
    x[0, 1, 1] = np.arange(16) - 7.5  # rows whose quotients sit on .5 ties
    x[1, 2, 2, :4] = [127.0, -127.0, 63.5, -0.5]
    for dtype in (jnp.bfloat16, jnp.float32):
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(_np(jx).copy()).to(torch.bfloat16 if dtype == jnp.bfloat16 else
                                          torch.float32)
        jq, js = jax.jit(jcm.kv_quantize)(jx)
        tq, ts = tcm.kv_quantize(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
        np.testing.assert_array_equal(_np(tcm.kv_dequantize(tq, ts)),
                                      _np(jax.jit(jcm.kv_dequantize)(jq, js)))
    # rows over 40 binades of magnitude
    wide = (rng.standard_normal((64, 64, 2, 16)) * np.exp(
        rng.uniform(-20, 20, (64, 64, 2, 1)))).astype(np.float32)
    jq, js = jax.jit(jcm.kv_quantize)(jnp.asarray(wide))
    tq, ts = tcm.kv_quantize(torch.from_numpy(wide))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_zero_slot_clears_the_int8_cache_and_its_scales(monkeypatch):
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    model = get_model("deepseek-moe-16b", smoke=True)
    logical = model.cache_logical()
    assert sorted(logical) == ["k_q", "k_s", "v_q", "v_s"]
    cache = {k: torch.ones_like(v) for k, v in model.init_cache(3, 6, "cpu").items()}
    assert cache["k_q"].dtype == torch.int8 and cache["k_s"].dtype == torch.float32
    assert cache["k_s"].shape == (3, 3, 6, 4, 1)
    wiped = tserve.zero_slot(cache, logical, 1)
    for name, arr in wiped.items():
        b = logical[name].index("batch")
        arr = arr.movedim(b, 0)
        assert (arr[1] == 0).all(), name
        assert (arr[0] == 1).all() and (arr[2] == 1).all(), name
    # kv_quant in the config turns it on as the variable does
    monkeypatch.delenv("REPRO_KV_QUANT")
    assert sorted(model.cache_logical()) == ["k", "v"]
    assert sorted(model.with_cfg(kv_quant=True).cache_logical()) == sorted(logical)


# ------------------------------------------------------------------ registry
def test_param_counts_equal_repro():
    for arch in MOE_ARCHS + ["gemma-2b", "gemma2-27b"]:
        for smoke in (False, True):
            jm, tm = jget_model(arch, smoke=smoke), get_model(arch, smoke=smoke)
            assert tm.param_count() == jm.param_count(), (arch, smoke)
            assert tm.active_param_count() == jm.active_param_count(), (arch, smoke)
    assert (get_model("deepseek-moe-16b").param_count(),
            get_model("deepseek-moe-16b").active_param_count()) == (16_375_728_128,
                                                                   2_326_906_880)
    assert (get_model("qwen3-moe-30b-a3b").param_count(),
            get_model("qwen3-moe-30b-a3b").active_param_count()) == (30_532_110_336,
                                                                    3_353_020_416)
    assert set(MOE_ARCHS) <= set(list_archs())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_params_have_repro_shapes(arch):
    """The port's own draws: per layer, the shapes and dtypes of repro's
    stacks (prefix first), and the smoke model's size equals param_count."""
    jm, tm = jget_model(arch, smoke=True), get_model(arch, smoke=True)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    tp = tm.init_params(device="cpu")
    cfg = tm.cfg
    npos = len(cfg.attn_pattern)
    for i, layer in enumerate(tp["layers"]):
        if i < cfg.n_dense_prefix:
            stack, j = shapes["prefix"], i
        else:
            stack, j = shapes["layers"][(i - cfg.n_dense_prefix) % npos], (
                i - cfg.n_dense_prefix) // npos
        flat_t = {"/".join(str(getattr(k, "key", k)) for k in path): v
                  for path, v in jax.tree_util.tree_flatten_with_path(layer)[0]}
        flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): v
                  for path, v in jax.tree_util.tree_flatten_with_path(stack)[0]}
        assert sorted(flat_t) == sorted(flat_j), i
        for name, t in flat_t.items():
            assert tuple(t.shape) == flat_j[name].shape[1:], (i, name)
            assert str(t.dtype).split(".")[1] == str(flat_j[name].dtype), (i, name)
        assert j < flat_j["ln1"].shape[0]
    n = sum(t.numel() for t in jax.tree.leaves(tp))
    assert n == tm.param_count()


# ------------------------------------------------------------ whole models
@pytest.fixture(scope="module")
def moe_models():
    """repro's MoE smoke models and their PRNGKey(0) parameters, and the
    port's from them, once per module."""
    out = {}
    for arch in MOE_ARCHS:
        jm = jget_model(arch, smoke=True)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = get_model(arch, smoke=True)
        tp = decoder_params_from_arrays(
            tm.cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
        out[arch] = (jm, jp, tm, tp)
    return out


def _logits_bar(want):
    top = float(np.abs(want).max())
    return dict(rtol=0, atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7))


def _same_choice(got, want):
    """The argmax agrees on every row whose top two logits (repro's) are more
    than twice the logit bar apart; closer rows have no decided choice at
    the bar's precision (bf16-rounded logits tie outright at times)."""
    bar = _logits_bar(want)["atol"]
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * bar
    agree = _np(got).argmax(-1) == want.argmax(-1)
    assert agree[decided].all(), (agree.tolist(), decided.tolist())


_REPRO_MOE_FFN, _ROUTE, _SELECT_EXPERTS = jmoe.moe_ffn, tmoe.route, tmoe.select_experts
#: most routing flips one run may force before it must agree with repro
MAX_FLIPS = 4


class RoutingRecorder:
    """Both packages' routing at each MoE layer call, in call order: repro's
    router inputs and top_ids from a `jax.debug.callback` on its real path,
    the port's from `moe.route`. The port takes repro's experts at the
    tokens of `force` ({call: {token: ids}})."""

    def __init__(self, monkeypatch, cfg):
        self.repro, self.port, self.force = [], [], {}
        self.cfg, k = cfg, cfg.moe.top_k

        def ffn(x, p, cfg, act="silu"):
            xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            ids = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], -1), k)[1]
            jax.debug.callback(lambda x_, r_, i_: self.repro.append(
                (np.asarray(x_), np.asarray(r_), np.asarray(i_))), xf, p["router"], ids,
                ordered=True)
            return _REPRO_MOE_FFN(x, p, cfg, act)

        def route(xf, router, cfg, c):
            forced = self.force.get(len(self.port), {})

            def pick(probs, k_):
                w, ids = _SELECT_EXPERTS(probs, k_)
                if forced:  # copies: top-k's backward reads the ids it chose
                    w, ids = w.clone(), ids.clone()
                for t, want in forced.items():
                    ids[t] = torch.as_tensor(want)
                    w[t] = probs[t, ids[t]] / probs[t, ids[t]].sum()
                return w, ids

            tmoe.select_experts = pick
            try:
                r = _ROUTE(xf, router, cfg, c)
            finally:
                tmoe.select_experts = _SELECT_EXPERTS
            self.port.append((xf.detach().float().numpy(), r.top_ids.numpy()))
            return r

        monkeypatch.setattr(jmoe, "moe_ffn", ffn)
        monkeypatch.setattr(tmoe, "route", route)

    def first_flips(self):
        """(call, {token: repro's ids}) of the first MoE call where the
        packages chose other expert sets, or None. Each flip there must be
        explained by the difference of the two router inputs (the logit gap
        within sum_i |dx_i| (|R_ia| + |R_ib|)), else AssertionError naming
        the call and the token."""
        assert len(self.repro) == len(self.port), (len(self.repro), len(self.port))
        n_moe = self.cfg.n_layers - self.cfg.n_dense_prefix
        for call, ((jx, router, jids), (tx, tids)) in enumerate(zip(self.repro, self.port)):
            tokens = np.nonzero((np.sort(jids, -1) != np.sort(tids, -1)).any(-1))[0]
            for t in tokens:
                logits = jx[t].astype(np.float64) @ router.astype(np.float64)
                slack = np.abs(jx[t] - tx[t]).astype(np.float64) @ np.abs(router)
                for a in set(jids[t]) - set(tids[t]):
                    for b in set(tids[t]) - set(jids[t]):
                        gap, bound = logits[a] - logits[b], slack[a] + slack[b] + 1e-5
                        assert gap <= bound, (
                            f"MoE call {call} (layer {self.cfg.n_dense_prefix + call % n_moe}, "
                            f"step {call // n_moe}), token {t}: repro routes to {a}, the port to "
                            f"{b}; their logit gap {gap:.3g} exceeds what the router "
                            f"inputs' difference explains ({bound:.3g})")
                        print(f"routing flip at MoE call {call} (layer "
                              f"{self.cfg.n_dense_prefix + call % n_moe}, step {call // n_moe}), "
                              f"token {t}: repro {a}, port {b}, logit gap {gap:.3g} <= "
                              f"{bound:.3g}")
            if len(tokens):
                return call, {int(t): jids[t].tolist() for t in tokens}
        return None


def run_matched(monkeypatch, cfg, run_repro, run_port):
    """(repro's result, the port's, the flips forced). Runs repro once and
    the port until its routing equals repro's at every MoE call, forcing
    repro's choice at each first flip in turn (at most MAX_FLIPS)."""
    rec = RoutingRecorder(monkeypatch, cfg)
    want = run_repro()
    for _ in range(MAX_FLIPS + 1):
        rec.port = []
        got = run_port()
        flip = rec.first_flips()
        if flip is None:
            return want, got, rec.force
        rec.force.setdefault(flip[0], {}).update(flip[1])
    raise AssertionError(f"more than {MAX_FLIPS} routing flips: {rec.force}")


def _jax_prefill_dense(jm, jp, toks):
    model = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, attn_impl="dense"))
    return np.asarray(model.prefill(jp, {"tokens": jnp.asarray(toks)}), np.float32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_matches_repro(moe_models, arch, impl, monkeypatch):
    """Each attention route of the port against repro's dense prefill ("flash"
    is the kernel's plain version on the CPU); the routing compared at every
    MoE layer (see the module docstring for flips)."""
    jm, jp, tm, tp = moe_models[arch]
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, size=(2, 16)).astype(np.int32)
    model = tm.with_cfg(attn_impl=impl)
    plain_calls = []

    def run_port():
        calls = ref.FLASH_CALLS
        out = model.prefill(tp, {"tokens": torch.from_numpy(toks)})
        plain_calls.append(ref.FLASH_CALLS - calls)
        return out

    want, got, _ = run_matched(monkeypatch, jm.cfg, lambda: _jax_prefill_dense(jm, jp, toks),
                               run_port)
    assert set(plain_calls) == {tm.cfg.n_layers if impl == "flash" else 0}
    assert got.shape == (2, 1, tm.cfg.vocab) and got.dtype == torch.float32
    _close(got, want, _logits_bar(want))
    _same_choice(got, want)


def test_moe_layers_follow_prefix_and_pattern(moe_models):
    """deepseek's layer 0 is the dense prefix (global attention, width
    dense_prefix_ff); the converted layers are repro's prefix then its
    pattern stacks, the router float32."""
    jm, jp, tm, tp = moe_models["deepseek-moe-16b"]
    cfg = tm.cfg
    assert [tdec.ffn_kind(cfg, i) for i in range(cfg.n_layers)] == [
        "dense_prefix", "moe", "moe"]
    assert tp["layers"][0]["wg"].shape == (cfg.d_model, cfg.dense_prefix_ff)
    for name, a in jp["prefix"].items():
        np.testing.assert_array_equal(_np(tp["layers"][0][name]), _np(a[0]))
    for i in (1, 2):
        for name, a in jp["layers"][0]["moe"].items():
            t = tp["layers"][i]["moe"][name]
            np.testing.assert_array_equal(_np(t), _np(a[i - 1]))
            assert t.dtype == (torch.float32 if name == "router" else torch.bfloat16)
    # after a prefix, the pattern restarts at the first layer past it
    local = dataclasses.replace(cfg, attn_pattern=("local", "global"), n_layers=5)
    assert [tdec.layer_kind(local, i) for i in range(5)] == [
        "global", "local", "global", "local", "global"]
    with pytest.raises(ValueError, match="prefix"):
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        del tree["prefix"]
        decoder_params_from_arrays(cfg, tree)


def _decode_inputs(vocab, steps=12, b=2, seed=6):
    """Tokens [steps, b, 1] and positions [steps, b] of a teacher-forced
    decode, slot 1 three rows behind slot 0."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(steps, b, 1)).astype(np.int32)
    return toks, (np.arange(steps)[:, None] + np.array([0, 3])).astype(np.int32)


def _repro_decode(jm, jp, toks, pos, cache_len=16):
    """repro's logits at each step of `toks` through its jitted decode_step."""
    shapes = jm.init_cache_shape(toks.shape[1], cache_len)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes,
                         is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    decode = jax.jit(jm.decode_step)
    out = []
    for t, p in zip(toks, pos):
        logits, cache = decode(jp, cache, {"tokens": jnp.asarray(t), "pos": jnp.asarray(p)})
        out.append(np.asarray(logits, np.float32))
    return out


def _port_decode(tm, tp, toks, pos, cache_len=16):
    """(the port's logits at each step, its cache at the end)."""
    cache = tm.init_cache(toks.shape[1], cache_len, "cpu")
    out = []
    for t, p in zip(toks, pos):
        logits, cache = tm.decode_step(tp, cache, {"tokens": torch.from_numpy(t),
                                                   "pos": torch.from_numpy(p)})
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_teacher_forced_decode_matches_repro(moe_models, arch, quant, monkeypatch):
    """Both packages' decode_step on one token sequence, slots at different
    positions, every step's logits compared (routing as in the module
    docstring)."""
    if quant:
        monkeypatch.setenv("REPRO_KV_QUANT", "1")
    jm, jp, tm, tp = moe_models[arch]
    toks, pos = _decode_inputs(tm.cfg.vocab)
    want, (got, tcache), _ = run_matched(monkeypatch, jm.cfg,
                                         lambda: _repro_decode(jm, jp, toks, pos),
                                         lambda: _port_decode(tm, tp, toks, pos))
    for w, g in zip(want, got):
        _close(g, w, _logits_bar(w))
        _same_choice(g, w)
    assert (tcache["k_q"].dtype == torch.int8) if quant else ("k" in tcache)


def test_int8_cache_decode_on_gemma_matches_repro(monkeypatch):
    """The int8 cache on a dense model with MQA and GeGLU (gemma-2b smoke)."""
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    jm = jget_model("gemma-2b", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model("gemma-2b", smoke=True)
    tp = decoder_params_from_arrays(tm.cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    toks, pos = _decode_inputs(tm.cfg.vocab)
    got, tcache = _port_decode(tm, tp, toks, pos)
    for w, g in zip(_repro_decode(jm, jp, toks, pos), got):
        _close(g, w, _logits_bar(w))
        _same_choice(g, w)
    # only written rows hold values: slot 0 wrote rows 0..11, slot 1 rows 3..14
    written = tcache["k_s"][0, :, :, 0, 0] > 0
    assert written[0, :12].all() and not written[0, 12:].any()
    assert written[1, 3:15].all() and not written[1, :3].any()
    prompts = [np.random.default_rng(1).integers(0, 512, size=n).tolist() for n in (6, 3, 9)]
    with set_mesh_compat(make_host_mesh()):
        want, want_steps = jserve.run_lm_server(jm, prompts, 4, 2, 14)
    got, got_steps = tserve.run_lm_server(tm, prompts, 4, 2, 14, params=tp, device="cpu")
    assert got == want and got_steps == want_steps


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_run_lm_server_matches_repro_token_for_token(moe_models, arch, quant, monkeypatch):
    """The serving loop token for token. A step whose choice is a near-tie
    (repro's top token ahead of the port's by at most twice the logit bar)
    takes repro's token and is named; routing as in the module docstring."""
    if quant:
        monkeypatch.setenv("REPRO_KV_QUANT", "1")
    jm, jp, tm, tp = moe_models[arch]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32).tolist()
               for n in (16, 5, 9, 16, 3, 7)]
    repro_logits = []

    def run_repro():
        with set_mesh_compat(make_host_mesh()):
            return jserve.run_lm_server(RecordingModel(jm, repro_logits), prompts, 8, 4, 24)

    runs = []

    def run_port():
        runs.append(TieBreakingModel(tm, repro_logits))
        return tserve.run_lm_server(runs[-1], prompts, 8, 4, 24, params=tp, device="cpu")

    (want, want_steps), (got, steps), _ = run_matched(monkeypatch, jm.cfg, run_repro, run_port)
    assert not runs[-1].problems, runs[-1].problems
    assert got == want and steps == want_steps


class RecordingModel:
    """repro's model with each decode step's logits recorded (a debug
    callback inside its jitted step)."""

    def __init__(self, model, sink):
        self.model, self.sink = model, sink

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, cache, batch):
        logits, cache = self.model.decode_step(params, cache, batch)
        jax.debug.callback(lambda x: self.sink.append(np.asarray(x, np.float32)), logits,
                           ordered=True)
        return logits, cache


class TieBreakingModel:
    """The port's model in the serving loop beside repro's logits of the same
    step: where the two argmaxes differ on a near-tie (repro's choice ahead
    of the port's by at most twice the logit bar in repro's logits, exact
    ties of bf16-rounded logits included) the port's logits are nudged to
    repro's choice; `problems` lists every other difference of choice."""

    def __init__(self, model, want):
        self.model, self.want, self.step, self.problems = model, want, 0, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, cache, batch):
        logits, cache = self.model.decode_step(params, cache, batch)
        want = self.want[self.step]
        bar = _logits_bar(want)["atol"]
        mine, theirs = _np(logits).argmax(-1)[:, 0], want.argmax(-1)[:, 0]
        for row in np.nonzero(mine != theirs)[0]:
            gap = want[row, 0, theirs[row]] - want[row, 0, mine[row]]
            if gap > 2 * bar:
                self.problems.append(f"step {self.step}, slot {row}: repro picks "
                                     f"{theirs[row]}, the port {mine[row]}, {gap:.3g} apart")
                continue
            print(f"near-tie at serving step {self.step}, slot {row}: repro's token "
                  f"{theirs[row]} leads the port's {mine[row]} by {gap:.3g}")
            logits[row, 0, theirs[row]] = logits[row, 0].max() + 1
        self.step += 1
        return logits, cache


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_mixed_length_batched_matches_single(arch):
    """Four slots give at most 4 x top_k slots to 8 capacity rows an expert,
    so nothing drops and a batched request's tokens equal serving it alone."""
    model = get_model(arch, smoke=True)
    params = model.init_params(device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=n).astype(np.int32).tolist()
               for n in (5, 9, 3, 7)]
    batched, _ = tserve.run_lm_server(model, prompts, 3, 4, 12, params=params, device="cpu")
    singles = [tserve.run_lm_server(model, [p], 3, 1, 12, params=params,
                                    device="cpu")[0][0] for p in prompts]
    assert batched == singles


def test_serve_cli_serves_the_moe_archs_on_the_cpu(capsys, monkeypatch):
    for arch in MOE_ARCHS:
        stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                             "--prompt-len", "4", "--gen", "2", "--slots", "2"])
        assert stats["requests"] == 3 and stats["steps"] == 10
        assert all(len(o) == 2 for o in stats["outputs"])
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    quant = tserve.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "4", "--gen", "2", "--slots", "2"])
    assert quant["requests"] == 3 and all(len(o) == 2 for o in quant["outputs"])
    assert capsys.readouterr().out.count("[serve] 3 requests, 10 decode steps") == 3
