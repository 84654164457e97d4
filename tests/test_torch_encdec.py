"""The port's encoder-decoder (whisper-large-v3) on the CPU, held against
`repro`.

The smoke model runs with `repro`'s own parameters (`init_params(PRNGKey(0))`,
crossed as float32 copies of bf16 values, which is exact) on the same
numpy inputs, against `jax.jit` of `repro`'s functions.

Bars, and why (those of tests/test_torch_lm.py):
  * bf16 features (the encoder's and decoder's outputs, after a layer
    norm): both packages compute in float32 and round to bf16, and a
    difference upstream flips some roundings; 4 bf16 steps at the largest
    |value| (a step at magnitude 2^e is 2^(e-7)).
  * logits: 4 bf16 steps at the largest |logit|, and the argmax equal on
    every row whose top two logits are more than twice that apart.
  * the sinusoid positions: bitwise (both cast one float64 table to bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jenc
from repro.models.registry import get_model as jget_model
from repro.models.registry import list_archs as jlist_archs
from repro_torch.convert import cache_from_arrays, params_from_arrays, params_to_arrays
from repro_torch.kernels import ref
from repro_torch.models import encdec as tenc
from repro_torch.models.registry import get_model, list_archs

torch.set_num_threads(1)

ARCH = "whisper-large-v3"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _steps(want, n=4):
    return n * 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)


def _close_steps(got, want, n=4):
    want = _np(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=_steps(want, n))


def _same_choice(got, want):
    bar = _steps(want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * bar
    agree = _np(got).argmax(-1) == want.argmax(-1)
    assert agree[decided].all(), (agree.tolist(), decided.tolist())


@pytest.fixture(scope="module")
def smoke():
    jm = jget_model(ARCH, smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model(ARCH, smoke=True)
    tp = params_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    return jm, jp, tm, tp


def _batch(tm, mode="prefill", b=2, seq=32, seed=0):
    """The port's example batch and the same numpy values for repro."""
    tb = tm.example_inputs(mode, b, seq, "cpu", seed=seed)
    jb = {k: jnp.asarray(_np(v)).astype(jnp.bfloat16) if v.dtype == torch.bfloat16
          else jnp.asarray(v.numpy()) for k, v in tb.items()}
    return jb, tb


def test_config_and_registry_mirror_repro():
    for smoke in (False, True):
        jc, tc = jget_model(ARCH, smoke=smoke).cfg, get_model(ARCH, smoke=smoke).cfg
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
    assert get_model(ARCH).family == "encdec"
    assert abs(get_model(ARCH).param_count() - 1.5788e9) < 1e6


@pytest.mark.parametrize("arch", jlist_archs())
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_make_inputs_mirror_repro(arch, mode):
    """Shapes, dtypes and logical axes of repro's make_inputs, for every arch
    (a vlm's seq counts its patches, an encdec's decoder takes seq // 8)."""
    jspec, jlog = jget_model(arch, smoke=True).make_inputs(mode, 2, 64)
    tm = get_model(arch, smoke=True)
    tspec, tlog = tm.make_inputs(mode, 2, 64)
    assert tlog == jlog and set(tspec) == set(jspec)
    for name, s in jspec.items():
        assert tspec[name].shape == s.shape, (name, tspec[name], s)
        assert str(tspec[name].dtype).split(".")[-1] == str(s.dtype), (name, tspec[name], s)
    batch = tm.example_inputs(mode, 2, 64, "cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {k: tspec[k].shape for k in tspec}
    assert list_archs() == jlist_archs()


def test_sinusoid_is_repro_bitwise():
    for s, d in ((32, 64), (1500, 1280)):
        got = tenc._sinusoid(s, d, "cpu")
        want = jenc._sinusoid(s, d)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))


def test_converted_layers_are_the_stacks(smoke):
    jm, jp, tm, tp = smoke
    assert len(tp["enc_layers"]) == 2 and len(tp["dec_layers"]) == 2
    for i, lp in enumerate(tp["dec_layers"]):
        for group in ("ln1", "ln_cross", "ln2", "attn", "cross"):
            for name, t in lp[group].items():
                np.testing.assert_array_equal(_np(t), _np(jp["dec_layers"][group][name][i]))
                assert t.dtype == (torch.float32 if group.startswith("ln") else torch.bfloat16)
        assert lp["b1"].dtype == torch.float32 and lp["w1"].dtype == torch.bfloat16
    back = params_to_arrays(tm, tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, _np(b))


def test_encode_matches_repro(smoke):
    jm, jp, tm, tp = smoke
    jb, tb = _batch(tm)
    want = jax.jit(lambda p, f: jenc.encode(p, f, jm.cfg))(jp, jb["frames"])
    got = tenc.encode(tp, tb["frames"], tm.cfg)
    assert got.dtype == torch.bfloat16
    _close_steps(got, want)


@pytest.mark.parametrize("impl", ["dense", "flash", "blockwise"])
def test_prefill_matches_repro(smoke, impl):
    """Each attention route against repro's dense prefill. "flash" is the
    kernel's plain version on the CPU: one call each for the encoder's
    self-attention (non-causal), the decoder's (causal) and its
    cross-attention (non-causal, 32 frames against 8 tokens)."""
    jm, jp, tm, tp = smoke
    jb, tb = _batch(tm, seed=1)
    want = np.asarray(jax.jit(jm.prefill)(jp, jb), np.float32)
    calls = ref.FLASH_CALLS
    got = tm.with_cfg(attn_impl=impl).prefill(tp, tb)
    n_flash = tm.cfg.n_enc_layers + 2 * tm.cfg.n_dec_layers
    assert ref.FLASH_CALLS - calls == (n_flash if impl == "flash" else 0)
    assert got.shape == (2, 1, tm.cfg.vocab) and got.dtype == torch.float32
    _close_steps(got, want)
    _same_choice(got, want)


def fill_cross_cache(params, cache, enc_out, cfg):
    """The cross cache's rows: the encoder's output through each decoder
    layer's cross wk / wv (repro's decode_step reads a cache its caller
    filled), in place for the port's flat cache."""
    b, t, _ = enc_out.shape
    for i, lp in enumerate(params["dec_layers"]):
        cache["cross_k"][i] = (enc_out @ lp["cross"]["wk"]).reshape(b, t, cfg.n_kv_heads,
                                                                    cfg.head_dim)
        cache["cross_v"][i] = (enc_out @ lp["cross"]["wv"]).reshape(b, t, cfg.n_kv_heads,
                                                                    cfg.head_dim)


def test_two_decode_steps_match_repro(smoke):
    """Both packages decode two tokens from one state: the cross cache
    filled from the port's encoder output, crossed to repro's nested cache
    through `convert`, and an empty self cache."""
    jm, jp, tm, tp = smoke
    cfg = tm.cfg
    jb, tb = _batch(tm, seed=2)
    t = tb["frames"].shape[1]
    cache = tm.init_cache(2, t, "cpu")
    with torch.no_grad():
        fill_cross_cache(tp, cache, tenc.encode(tp, tb["frames"], cfg), cfg)
    jcache = {"self": (_np(cache["self_k"]), _np(cache["self_v"])),
              "cross": (_np(cache["cross_k"]), _np(cache["cross_v"]))}
    crossed = cache_from_arrays(tm, jcache)
    for k in cache:
        assert torch.equal(crossed[k], cache[k])
    jcache = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jcache)
    decode = jax.jit(jm.decode_step)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 2, 1)).astype(np.int32)
    for i in range(2):
        want, jcache = decode(jp, jcache, {"tokens": jnp.asarray(toks[i]),
                                           "pos": jnp.asarray(i, jnp.int32)})
        got, cache = tm.decode_step(tp, cache, {"tokens": torch.from_numpy(toks[i]), "pos": i})
        want = np.asarray(want, np.float32)
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        _close_steps(got, want)
        _same_choice(got, want)
    # the self rows written in place are repro's, the cross rows untouched
    _close_steps(cache["self_k"][:, :, :2], jcache["self"][0][:, :, :2])
    assert torch.equal(cache["cross_k"], crossed["cross_k"])


def test_cache_shapes_and_logical_mirror_repro():
    jm, tm = jget_model(ARCH, smoke=True), get_model(ARCH, smoke=True)
    jshape = jm.init_cache_shape(2, 24)
    tshape = tm.init_cache_shape(2, 24)
    assert set(tshape) == {"self_k", "self_v", "cross_k", "cross_v"}
    for k, s in tshape.items():
        part, i = k.split("_")
        assert s.shape == jshape[part][0 if i == "k" else 1].shape
        assert s.dtype == torch.bfloat16
    jl = jm.cache_logical()
    assert tm.cache_logical() == {"self_k": jl["self"][0], "self_v": jl["self"][1],
                                  "cross_k": jl["cross"][0], "cross_v": jl["cross"][1]}
