"""The port's vision-language model (internvl2-2b) on the CPU, held against
`repro`.

Every comparison runs `jax.jit` of `repro`'s function on the same numpy
inputs; parameters are `repro`'s `init_params(PRNGKey(0))` crossed by
`convert`.

Tolerances, and why:
  * the projector and the embedding rows (bf16): rtol 1/128, one bf16 step,
    atol 1e-5: both sides round the first product, the tanh GELU (float32)
    and the second product to bf16 at the same places; only the sums inside
    the products may order differently;
  * decoder features from `embeds=` (bf16): rtol 1/128 and an atol of 4
    bf16 steps at the largest |feature|: a flipped rounding upstream moves
    the products after it by a few steps of their own magnitude;
  * logits: 4 bf16 steps at the largest |logit| (tests/test_torch_lm.py),
    and the argmax equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decoder as jdec
from repro.models import vlm as jvlm
from repro.models.registry import get_model as jget_model
from repro_torch.convert import cache_from_arrays, params_from_arrays
from repro_torch.kernels import ref
from repro_torch.models import decoder as tdec
from repro_torch.models import vlm as tvlm
from repro_torch.models.registry import get_model

torch.set_num_threads(1)

BF16 = dict(rtol=1 / 128, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _steps(want, n=4):
    top = float(np.abs(_np(want)).max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.fixture(scope="module")
def smoke():
    jm = jget_model("internvl2-2b", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model("internvl2-2b", smoke=True)
    tp = params_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    return jm, jp, tm, tp


def _batch(cfg, b=2, n_text=8, seed=0):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((b, cfg.n_patches, cfg.vit_dim), dtype=np.float32)
    toks = rng.integers(0, cfg.lm.vocab, size=(b, n_text)).astype(np.int32)
    return ({"patch_embeds": jnp.asarray(patches), "tokens": jnp.asarray(toks)},
            {"patch_embeds": torch.from_numpy(patches), "tokens": torch.from_numpy(toks)})


def test_project_and_embeds_match_repro(smoke):
    jm, jp, tm, tp = smoke
    jb, tb = _batch(tm.cfg)
    want = jax.jit(jvlm._project)(jb["patch_embeds"], jp["projector"])
    got = tvlm._project(tb["patch_embeds"], tp["projector"])
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)
    want = jax.jit(lambda p, b: jvlm._embeds(p, b, jm.cfg))(jp, jb)
    got = tvlm._embeds(tp, tb, tm.cfg)
    assert got.shape == (2, tm.cfg.n_patches + 8, tm.cfg.lm.d_model)
    _close(got, want, BF16)
    # image rows first, then the text's embedding rows as they are
    np.testing.assert_array_equal(_np(got[:, tm.cfg.n_patches:]),
                                  _np(tp["lm"]["embed"][tb["tokens"]]))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decoder_forward_takes_embeds(smoke, dtype):
    """`embeds` stand in for the token embeddings: cast to bf16, no
    embedding scale, positions 0..S-1 over the whole row."""
    jm, jp, tm, tp = smoke
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((2, 12, tm.cfg.lm.d_model), dtype=np.float32)
    jemb = jnp.asarray(emb).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    temb = torch.from_numpy(emb).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want, _ = jax.jit(lambda p, e: jdec.forward(p, None, jm.cfg.lm, embeds=e))(jp["lm"], jemb)
    got, _ = tdec.forward(tp["lm"], None, tm.cfg.lm, embeds=temb)
    assert got.dtype == torch.bfloat16
    _close(got, want, dict(rtol=1 / 128, atol=_steps(want)))
    # an embedding scale would not apply to embeds: gemma's config with it on
    scaled = get_model("gemma-2b", smoke=True)
    sp = scaled.init_params(device="cpu")
    toks = torch.tensor([[1, 2, 3]])
    a, _ = tdec.forward(sp, toks, scaled.cfg)
    b, _ = tdec.forward(sp, None, scaled.cfg, embeds=tdec.cm.embed(toks, sp["embed"], True))
    assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_matches_repro(smoke, impl):
    jm, jp, tm, tp = smoke
    jb, tb = _batch(tm.cfg, seed=2)
    want = np.asarray(jax.jit(jm.prefill)(jp, jb), np.float32)
    calls = ref.FLASH_CALLS
    got = tm.with_cfg(attn_impl=impl).prefill(tp, tb)
    assert ref.FLASH_CALLS - calls == (tm.cfg.lm.n_layers if impl == "flash" else 0)
    assert got.shape == (2, 1, tm.cfg.lm.vocab) and got.dtype == torch.float32
    _close(got, want, dict(rtol=0, atol=_steps(want)))
    np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


def test_with_cfg_reaches_the_decoder(smoke):
    _, _, tm, _ = smoke
    assert tm.with_cfg(attn_impl="flash").cfg.lm.attn_impl == "flash"
    assert tm.with_cfg(n_patches=4).cfg.n_patches == 4


def test_teacher_forced_decode_matches_repro(smoke):
    """Text decode from a cache `repro` filled, carried across by
    `cache_from_arrays`, slots at their own positions."""
    jm, jp, tm, tp = smoke
    rng = np.random.default_rng(3)
    b, cache_len, steps = 2, 16, 10
    toks = rng.integers(0, tm.cfg.lm.vocab, size=(steps, b, 1)).astype(np.int32)
    offsets = np.array([0, 2])
    shapes = jm.init_cache_shape(b, cache_len)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes,
                          is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    decode = jax.jit(jm.decode_step)

    def jstep(cache, i):
        return decode(jp, cache, {"tokens": jnp.asarray(toks[i]),
                                  "pos": jnp.asarray((i + offsets).astype(np.int32))})

    for i in range(3):
        _, jcache = jstep(jcache, i)
    tcache = cache_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jcache))
    assert set(tcache) == {"k", "v"}
    for i in range(3, steps):
        want, jcache = jstep(jcache, i)
        got, tcache = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(toks[i]),
                                                  "pos": torch.from_numpy(i + offsets)})
        want = np.asarray(want, np.float32)
        _close(got, want, dict(rtol=0, atol=_steps(want)))
        np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


def test_config_mirrors_repro():
    for smoke_ in (False, True):
        jc, tc = jget_model("internvl2-2b", smoke=smoke_).cfg, get_model(
            "internvl2-2b", smoke=smoke_).cfg
        assert (tc.vit_dim, tc.n_patches, tc.sub_quadratic) == (jc.vit_dim, jc.n_patches,
                                                                 jc.sub_quadratic)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
                  "act", "rope_theta", "tie_embed", "attn_impl"):
            assert getattr(tc.lm, f) == getattr(jc.lm, f), (smoke_, f)
        assert tc.param_count() == jc.param_count()
    model = get_model("internvl2-2b", smoke=True)
    assert model.cache_logical() == tdec.cache_logical(model.cfg.lm)
    assert set(model.init_cache(2, 4, "cpu")) == {"k", "v"}
