"""The port's dense decoder and LM serving on the CPU, held against `repro`.

Each ported layer of `repro_torch.models.common` is fed the same numpy
inputs as its `repro.models.common` twin, in float32 and in bf16; the
gemma-2b, gemma2-27b, internlm2-20b and minitron-8b (relu2) smoke models run
with `repro`'s own parameters (`init_params(PRNGKey(0))`, crossed as float32
copies of bf16 values, which is exact) through prefill, teacher-forced
decode and the serving loop; the serving loop also over the ssm, hybrid and
vlm families (mamba2-130m, zamba2-2.7b, internvl2-2b), whose layers
tests/test_torch_{ssm,hybrid,vlm}.py hold.

Tolerances, and why:
  * float32 layers: rtol 1e-5, atol 1e-5. XLA and PyTorch evaluate rsqrt,
    tanh, exp, sin, cos and pow with different approximations (a few ulps)
    and sum in different orders.
  * bf16 layers: rtol 1/128 (one bf16 ulp: both sides compute in float32
    and round once, so they differ by at most a rounding step), atol 1e-5.
  * logits: both packages round the unembedding product to bf16, so a
    logit of magnitude in [2^e, 2^(e+1)) moves in steps of 2^(e-7); a
    difference upstream flips some roundings. The bar is 4 such steps at
    the largest |logit| (gemma-2b reads at most 1.1), and 8 where the config
    has a Python-float `query_scale` (gemma2-27b reads up to 4.5): there the
    attention scores themselves are rounded to bf16, so one flipped score
    rounding moves its softmax weight by |score| / 128. The argmax must agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh, set_mesh_compat
from repro.launch import serve as jserve
from repro.models import common as jcm
from repro.models.registry import get_model as jget_model
from repro_torch.convert import decoder_params_from_arrays, params_from_arrays
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcm
from repro_torch.models import decoder as tdec
from repro_torch.models.registry import get_model, list_archs
from test_torch_moe import RecordingModel, TieBreakingModel

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1 / 128, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32, F32), "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
ARCHS = ["gemma-2b", "gemma2-27b", "internlm2-20b", "minitron-8b"]
#: the MoE decoders (tests/test_torch_moe.py holds their models against repro)
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
#: the other families the serving loop drives
FAMILY_ARCHS = ["mamba2-130m", "zamba2-2.7b", "internvl2-2b"]


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, bar):
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _logits_bar(want, cfg):
    top = float(np.abs(want).max())
    steps = 4 if cfg.query_scale is None else 8
    return dict(rtol=0, atol=steps * 2.0 ** (np.floor(np.log2(top)) - 7))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_softcap_rope(dtype):
    rng = np.random.default_rng(0)
    bar = DTYPES[dtype][2]
    jx, tx = _pair(_arr(rng, 2, 5, 3, 16, scale=3.0), dtype)
    js, ts = _pair(_arr(rng, 16, scale=0.1), "f32")
    _close(tcm.rms_norm(tx, ts), jcm.rms_norm(jx, js), bar)
    _close(tcm.softcap(tx, 2.0), jcm.softcap(jx, 2.0), bar)
    pos = np.array([[0, 3, 7, 100, 4095], [1, 2, 3, 4, 5]], np.int32)
    _close(tcm.rope(tx, torch.from_numpy(pos)), jcm.rope(jx, jnp.asarray(pos)), bar)
    _close(tcm.rope(tx, torch.arange(5)), jcm.rope(jx, jnp.arange(5)), bar)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [None, 0.25, (4608 / 32) ** -0.5],
                         ids=["numpy-default", "py-0.25", "py-gemma2"])
@pytest.mark.parametrize("window,cap", [(None, None), (5, 50.0)])
def test_dense_and_blockwise_attention(dtype, scale, window, cap):
    """Both query-scale promotions: the default (a float64 numpy scalar) makes
    q float32; a Python float keeps a bf16 q in bf16."""
    rng = np.random.default_rng(1)
    bar = DTYPES[dtype][2]
    jq, tq = _pair(_arr(rng, 2, 16, 4, 8), dtype)
    jk, tk = _pair(_arr(rng, 2, 16, 2, 8), dtype)
    jv, tv = _pair(_arr(rng, 2, 16, 2, 8), dtype)
    kw = dict(window=window, scale=scale)
    want = jcm.dense_attention(jq, jk, jv, attn_softcap=cap, **kw)
    got = tcm.dense_attention(tq, tk, tv, attn_softcap=cap, **kw)
    assert got.dtype == tv.dtype
    _close(got, want, bar)
    want = jcm.blockwise_attention(jq, jk, jv, attn_softcap=cap, q_block=8, kv_block=4, **kw)
    got = tcm.blockwise_attention(tq, tk, tv, attn_softcap=cap, q_block=8, kv_block=4, **kw)
    _close(got, want, bar)


def test_query_scale_promotion_matches_jax_dtypes():
    q = torch.ones(1, 1, 1, 16, dtype=torch.bfloat16)
    assert tcm.scale_query(q, None).dtype == torch.float32
    assert tcm.scale_query(q, 0.1).dtype == torch.bfloat16
    jq = jnp.ones((1, 1, 1, 16), jnp.bfloat16)
    assert (jq * (1.0 / np.sqrt(16))).dtype == jnp.float32
    assert (jq * 0.1).dtype == jnp.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_decode_attention_valid_len_and_window(dtype, window, scale):
    rng = np.random.default_rng(2)
    bar = DTYPES[dtype][2]
    jq, tq = _pair(_arr(rng, 3, 1, 4, 8), dtype)
    jk, tk = _pair(_arr(rng, 3, 10, 1, 8), dtype)
    jv, tv = _pair(_arr(rng, 3, 10, 1, 8), dtype)
    vl = np.array([1, 6, 10], np.int32)
    kw = dict(window=window, attn_softcap=30.0, scale=scale)
    _close(tcm.decode_attention(tq, tk, tv, valid_len=torch.from_numpy(vl), **kw),
           jcm.decode_attention(jq, jk, jv, valid_len=jnp.asarray(vl), **kw), bar)
    _close(tcm.decode_attention(tq, tk, tv, **kw), jcm.decode_attention(jq, jk, jv, **kw), bar)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(dtype, act):
    rng = np.random.default_rng(3)
    bar = DTYPES[dtype][2]
    x = _pair(_arr(rng, 2, 3, 16), dtype)
    ws = [_pair(_arr(rng, *s, scale=0.25), dtype) for s in ((16, 32), (16, 32), (32, 16))]
    _close(tcm.gated_mlp(x[1], *(w[1] for w in ws), act=act),
           jcm.gated_mlp(x[0], *(w[0] for w in ws), act=act), bar)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed_last_token(dtype):
    rng = np.random.default_rng(4)
    jt, tt = _pair(_arr(rng, 50, 16, scale=0.25), dtype)
    toks = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    for scaled in (False, True):
        want = jcm.embed(jnp.asarray(toks), jt, scaled)
        got = tcm.embed(torch.from_numpy(toks), tt, scaled)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))  # one rounding, same bits
    jx, tx = _pair(_arr(rng, 2, 7, 16), dtype)
    for cap in (None, 30.0):
        _close(tcm.unembed(tx, tt, cap), jcm.unembed(jx, jt, cap), DTYPES[dtype][2])
        _close(tcm.last_token_logits(tx, tt, cap), jcm.last_token_logits(jx, jt, cap),
               DTYPES[dtype][2])


def test_ninit_is_seeded_and_scaled():
    g = torch.Generator().manual_seed(0)
    a = tcm.ninit(g, (4096, 64))
    b = tcm.ninit(torch.Generator().manual_seed(0), (4096, 64))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert abs(float(a.float().std()) - 1 / 64) < 1e-3


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module")
def jax_models():
    """repro's smoke models and their PRNGKey(0) parameters, once per module."""
    out = {}
    for arch in ARCHS + MOE_ARCHS + FAMILY_ARCHS:
        jm = jget_model(arch, smoke=True)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = get_model(arch, smoke=True)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        tp = (decoder_params_from_arrays(tm.cfg, tree) if tm.family == "decoder"
              else params_from_arrays(tm, tree))
        out[arch] = (jm, jp, tm, tp)
    return out


def test_registry_and_configs_mirror_repro():
    """The port registers every arch of repro, the encoder-decoder
    whisper-large-v3 included, in repro's ALL_ARCHS order."""
    from repro.configs import ALL_ARCHS as JALL
    from repro.models.registry import list_archs as jlist_archs
    from repro_torch.configs import ALL_ARCHS

    assert list_archs() == jlist_archs()
    assert ALL_ARCHS == JALL
    for arch in FAMILY_ARCHS + ["whisper-large-v3"]:
        assert get_model(arch).family == jget_model(arch).family
    for arch in ARCHS + MOE_ARCHS:
        for smoke in (False, True):
            jc, tc = jget_model(arch, smoke=smoke).cfg, get_model(arch, smoke=smoke).cfg
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                      "vocab", "act", "attn_pattern", "window", "attn_softcap",
                      "final_softcap", "query_scale", "embed_scale", "tie_embed",
                      "post_norms", "rope_theta", "norm_eps", "n_dense_prefix",
                      "dense_prefix_ff", "kv_quant", "remat", "attn_impl", "sub_quadratic"):
                assert getattr(tc, f) == getattr(jc, f), (arch, smoke, f)
            assert (tc.moe is None) == (jc.moe is None), (arch, smoke)
            if tc.moe is not None:
                assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe), (arch, smoke)
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
    assert get_model("gemma-2b").param_count() == 2_506_172_416
    assert get_model("whisper-large-v3").param_count() == jget_model(
        "whisper-large-v3").param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        get_model("whisper-tiny")


def test_unported_features_raise(monkeypatch):
    """What the port does not do raises: a loss through the flash route
    (neither kernel has a backward), the serve CLI on the encdec family (as
    repro's refuses it), an unknown family and unknown attention routes.
    MoE layers, dense prefixes, the int8 cache and every family build."""
    from repro_torch.kernels.ops import FlashBackwardError
    from repro_torch.launch.steps import value_and_grad

    m = get_model("gemma-2b", smoke=True)
    g = torch.Generator().manual_seed(0)
    moe = get_model("deepseek-moe-16b", smoke=True).cfg.moe
    params = m.with_cfg(moe=moe, n_dense_prefix=1, dense_prefix_ff=48).init_params(g)
    assert "moe" in params["layers"][1] and params["layers"][0]["wg"].shape == (64, 48)
    assert set(m.with_cfg(kv_quant=True).init_cache_shape(2, 8)) == {"k_q", "k_s", "v_q", "v_s"}
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    assert m.init_cache_shape(2, 8)["k_q"].dtype == torch.int8
    monkeypatch.delenv("REPRO_KV_QUANT")
    batch = m.example_inputs("train", 2, 8, "cpu")
    with pytest.raises(FlashBackwardError, match="no backward"):
        value_and_grad(m.with_cfg(attn_impl="flash"), m.init_params(g), batch)
    with pytest.raises(NotImplementedError, match="'audio' family"):
        dataclasses.replace(m, family="audio").init_params(g)
    monkeypatch.setattr(tserve, "get_model",
                        lambda *a, **k: dataclasses.replace(m, family="encdec"))
    with pytest.raises(SystemExit, match="decoder-family archs"):  # repro's refusal
        tserve.main(["--arch", "whisper-large-v3", "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="attn_impl"):
        m.with_cfg(attn_impl="flash_pallas").init_params(g)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_converted_layers_follow_the_pattern_stacks(jax_models, arch):
    """Layer i is repro's prefix layer i, then pattern stack (i - prefix) %
    len(pattern), group (i - prefix) // len(pattern); norms and the MoE
    router float32, all else bf16."""
    jm, jp, tm, tp = jax_models[arch]
    npos, n_prefix = len(tm.cfg.attn_pattern), tm.cfg.n_dense_prefix
    assert len(tp["layers"]) == tm.cfg.n_layers
    for i, layer in enumerate(tp["layers"]):
        j = i - n_prefix
        stack, g = ((jp["prefix"], i) if i < n_prefix else
                    (jp["layers"][j % npos], j // npos))
        leaves = [(name, t, stack[name]) for name, t in layer.items() if name != "moe"]
        leaves += [(name, t, stack["moe"][name]) for name, t in layer.get("moe", {}).items()]
        assert len(leaves) == len(jax.tree.leaves(stack))
        for name, t, a in leaves:
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(a[g], np.float32))
            assert t.dtype == (torch.float32 if name.startswith(("ln", "post")) or
                               name == "router" else torch.bfloat16), name


@pytest.mark.parametrize("impl", ["dense", "flash", "blockwise", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_repro(jax_models, arch, impl):
    """The port's attention routes against repro's dense prefill ("flash" is
    the kernel's plain version on the CPU)."""
    jm, jp, tm, tp = jax_models[arch]
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, size=(2, 16)).astype(np.int32)
    want = _jax_prefill_dense(jm, jp, toks)
    calls = ref.FLASH_CALLS
    got = tm.with_cfg(attn_impl=impl).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert ref.FLASH_CALLS - calls == (tm.cfg.n_layers if impl == "flash" else 0)
    assert got.shape == (2, 1, tm.cfg.vocab) and got.dtype == torch.float32
    _close(got, want, _logits_bar(want, tm.cfg))
    np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


def _jax_prefill_dense(jm, jp, toks):
    model = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, attn_impl="dense"))
    return np.asarray(model.prefill(jp, {"tokens": jnp.asarray(toks)}), np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_repro(jax_models, arch):
    """Feed one token sequence through decode_step in both packages, slots at
    different positions, and compare the logits of every step."""
    jm, jp, tm, tp = jax_models[arch]
    rng = np.random.default_rng(6)
    steps, b, cache_len = 12, 2, 16
    toks = rng.integers(0, tm.cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    offsets = np.array([0, 3])  # slot 1 starts three rows later
    shapes = jm.init_cache_shape(b, cache_len)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes,
                          is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    tcache = tm.init_cache(b, cache_len, "cpu")
    decode = jax.jit(jm.decode_step)
    for i in range(steps):
        pos = (i + offsets).astype(np.int32)
        want, jcache = decode(jp, jcache, {"tokens": jnp.asarray(toks[i]),
                                           "pos": jnp.asarray(pos)})
        got, tcache = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(toks[i]),
                                                  "pos": torch.from_numpy(pos)})
        want = np.asarray(want, np.float32)
        _close(got, want, _logits_bar(want, tm.cfg))
        np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_run_lm_server_matches_repro_token_for_token(jax_models, arch):
    """The serving loop token for token. A step whose choice is a near-tie
    (repro's top token ahead of the port's by at most twice the logit bar)
    takes repro's token and is named, as in tests/test_torch_moe.py; any
    other difference of choice fails. gemma-2b and gemma2-27b run without
    it, as before this slice (minitron-8b's smoke model meets a near-tie)."""
    jm, jp, tm, tp = jax_models[arch]
    rng = np.random.default_rng(0)
    vocab = tm.cfg.lm.vocab if tm.family == "vlm" else tm.cfg.vocab
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32).tolist()
               for n in (16, 5, 9, 16, 3, 7)]
    repro_logits = []
    with set_mesh_compat(make_host_mesh()):
        want, want_steps = jserve.run_lm_server(RecordingModel(jm, repro_logits), prompts,
                                                8, 4, 24)
    launches = fa.LAUNCHES
    port = tm if arch in ("gemma-2b", "gemma2-27b") else TieBreakingModel(tm, repro_logits)
    got, steps = tserve.run_lm_server(port, prompts, 8, 4, 24, params=tp, device="cpu")
    assert not getattr(port, "problems", []), port.problems
    assert got == want and steps == want_steps
    assert fa.LAUNCHES == launches


# -------------------------------------------- mirrors of tests/test_serve_slots.py
PROMPT_LENS = (5, 9, 3, 7)


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_mixed_length_batched_matches_single(arch):
    model = get_model(arch, smoke=True)
    params = model.init_params(device="cpu")
    rng = np.random.default_rng(0)
    vocab = model.cfg.lm.vocab if model.family == "vlm" else model.cfg.vocab
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32).tolist()
               for n in PROMPT_LENS]
    cache_len = max(PROMPT_LENS) + 3
    batched, _ = tserve.run_lm_server(model, prompts, 3, 2, cache_len, params=params,
                                      device="cpu")
    singles = [tserve.run_lm_server(model, [p], 3, 1, cache_len, params=params,
                                    device="cpu")[0][0] for p in prompts]
    assert batched == singles


def test_decode_step_vector_pos_matches_scalar():
    model = get_model("gemma-2b", smoke=True)
    params = model.init_params(device="cpu")
    toks = torch.tensor([[3], [5]])
    a_logits, a_cache = model.decode_step(params, model.init_cache(2, 8, "cpu"),
                                          {"tokens": toks, "pos": torch.tensor(2)})
    b_logits, b_cache = model.decode_step(params, model.init_cache(2, 8, "cpu"),
                                          {"tokens": toks, "pos": torch.tensor([2, 2])})
    assert torch.equal(a_logits, b_logits)
    for name in a_cache:
        assert torch.equal(a_cache[name], b_cache[name])
        assert a_cache[name][:, :, 2].abs().sum() > 0  # the rows were written
        assert a_cache[name][:, :, :2].abs().sum() == 0 and a_cache[name][:, :, 3:].abs().sum() == 0


@pytest.mark.parametrize("arch", ["gemma2-27b"] + FAMILY_ARCHS)
def test_zero_slot_clears_only_that_lane(arch):
    """Every cache tensor: KV rows, and the Mamba layers' ssm state and conv
    rows (tests/test_serve_slots.py:91-92 on the hybrid)."""
    model = get_model(arch, smoke=True)
    logical = model.cache_logical()
    cache = {k: torch.ones_like(v) for k, v in model.init_cache(3, 6, "cpu").items()}
    wiped = tserve.zero_slot(cache, logical, 1)
    for name, arr in wiped.items():
        b = logical[name].index("batch")
        arr = arr.movedim(b, 0)
        assert (arr[1] == 0).all()
        assert (arr[0] == 1).all() and (arr[2] == 1).all()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_cli_serves_every_family(arch, capsys):
    stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                         "--prompt-len", "4", "--gen", "2", "--slots", "2"])
    assert stats["requests"] == 3 and all(len(o) == 2 for o in stats["outputs"])
    assert "[serve] 3 requests" in capsys.readouterr().out


def test_serve_cli_on_the_cpu(capsys):
    stats = tserve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--requests", "3",
                         "--prompt-len", "4", "--gen", "2", "--slots", "2"])
    assert stats["requests"] == 3 and stats["steps"] == 10 and stats["device"] == "CPU"
    assert all(len(o) == 2 for o in stats["outputs"])
    assert "[serve] 3 requests, 10 decode steps" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--epi requires --queries"):
        tserve.main(["--epi"])


def test_decoder_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "gemma-2b", "--smoke"])  # --device defaults to cuda
    model = get_model("gemma-2b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.run_lm_server(model, [[1, 2]], 1, 1, 4)
    assert tdec.layer_kind(get_model("gemma2-27b", smoke=True).cfg, 3) == "global"
