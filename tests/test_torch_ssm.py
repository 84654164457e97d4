"""The port's Mamba-2 layers and mamba2-130m on the CPU, held against `repro`.

Every comparison runs `jax.jit` of `repro`'s function, as `repro` runs it
(inside `lax.scan` and `jit`), on the same numpy inputs; model parameters
are `repro`'s `init_params(PRNGKey(0))` crossed by `convert`.

Tolerances, and why:
  * float32 inputs (`ssd_chunked`): rtol 1e-5, atol 1e-5. `torch.cumsum`
    accumulates in float64 on the CPU where XLA sums left to right in
    float32, and XLA may fuse the state update into an fma, so the decays
    and states differ by float32 ulps.
  * bf16 blocks (the conv, `mamba_block`, `mamba_decode_block`): rtol 1/128,
    one bf16 step, atol 1e-5; the float32 ssm state of a decode step at the
    float32 bar. The port rounds where XLA's compiled form rounds (see
    `models/ssm.py`), and at these widths the blocks agree to the bit.
  * logits: the step bar of tests/test_torch_lm.py: 4 bf16 steps at the
    largest |logit|, and the argmax equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh, set_mesh_compat
from repro.models import ssm as jssm
from repro.models.registry import get_model as jget_model
from repro_torch.convert import cache_from_arrays, params_from_arrays
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import get_model

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1 / 128, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _logits_bar(want):
    top = float(np.abs(want).max())
    return dict(rtol=0, atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7))


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _ssd_inputs(seed, b=2, s=16, h=4, p=8, g=2, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B_in = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.5
    C_in = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.5
    state = rng.standard_normal((b, h, n, p), dtype=np.float32) * 0.1
    return x, dt, A, B_in, C_in, state


@pytest.fixture(scope="module")
def smoke():
    """repro's mamba2-130m smoke model, its PRNGKey(0) parameters, and the
    port's model with those parameters crossed over."""
    jm = jget_model("mamba2-130m", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model("mamba2-130m", smoke=True)
    tp = params_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    return jm, jp, tm, tp


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("carried", [False, True], ids=["zero-state", "init-state"])
def test_ssd_chunked_float32_matches_repro(chunk, carried):
    """Two groups of two heads each (tests/test_layers_property.py:80's
    shape): a group -> head broadcast by tiling instead of
    `repeat_interleave` would pair heads with the wrong B and C."""
    x, dt, A, B_in, C_in, state = _ssd_inputs(chunk)
    init = state if carried else None
    want_y, want_s = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(
        x, dt, A, B_in, C_in, chunk=chunk, init_state=init)
    got_y, got_s = tssm.ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, A, B_in, C_in)), chunk,
        None if init is None else torch.from_numpy(init))
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    _close(got_y, want_y, F32)
    _close(got_s, want_s, F32)


def test_ssd_groups_are_repeated_not_tiled():
    """With heads 0, 1 in group 0 and 2, 3 in group 1, zeroing group 1's B
    leaves only heads 2 and 3 without output."""
    x, dt, A, B_in, C_in, _ = _ssd_inputs(1)
    B_in[:, :, 1] = 0.0
    y, _ = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B_in, C_in)), 8)
    per_head = y.abs().sum(dim=(0, 1, 3))
    assert (per_head[:2] > 0).all() and (per_head[2:] == 0).all()


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_chunked_bf16_matches_repro(chunk):
    x, dt, A, B_in, C_in, _ = _ssd_inputs(10 + chunk)
    (jx, tx), (jb, tb), (jc, tc) = _bf16(x), _bf16(B_in), _bf16(C_in)
    want_y, want_s = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(
        jx, dt, A, jb, jc, chunk=chunk)
    got_y, got_s = tssm.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc,
                                    chunk)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    _close(got_y, want_y, BF16)
    _close(got_s, want_s, F32)


@pytest.mark.parametrize("streaming", [False, True], ids=["prefill", "streaming"])
def test_causal_conv_matches_repro(streaming):
    rng = np.random.default_rng(3)
    s = 1 if streaming else 9
    jx, tx = _bf16(rng.standard_normal((2, s, 24), dtype=np.float32))
    jw, tw = _bf16(rng.standard_normal((4, 24), dtype=np.float32) * 0.5)
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 24), dtype=np.float32) if streaming else None
    jst, tst = _bf16(st) if streaming else (None, None)
    want, want_state = jax.jit(jssm._causal_conv)(jx, jw, b, jst)
    got, got_state = tssm._causal_conv(tx, tw, torch.from_numpy(b), tst)
    assert got.dtype == torch.bfloat16 and got_state.dtype == torch.bfloat16
    _close(got, want, BF16)
    np.testing.assert_array_equal(_np(got_state), _np(want_state))  # rows, moved


def test_softplus_is_logaddexp():
    x = torch.linspace(-30, 30, 2001)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tssm.softplus(x).numpy(), want, **F32)


def test_mamba_block_matches_repro(smoke):
    jm, jp, tm, tp = smoke
    rng = np.random.default_rng(4)
    jx, tx = _bf16(rng.standard_normal((2, 32, tm.cfg.d_model), dtype=np.float32))
    layer = jax.tree.map(lambda a: a[1], jp["layers"])
    want = jax.jit(lambda x, p: jssm.mamba_block(x, p, jm.cfg))(jx, layer)
    got = tssm.mamba_block(tx, tp["layers"][1], tm.cfg)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


def test_mamba_decode_block_matches_repro(smoke):
    jm, jp, tm, tp = smoke
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    jx, tx = _bf16(rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32))
    ssm = rng.standard_normal((3, cfg.n_heads, cfg.d_state, cfg.head_dim),
                              dtype=np.float32) * 0.1
    jc, tc = _bf16(rng.standard_normal((3, cfg.conv_width - 1, cfg.conv_channels),
                                       dtype=np.float32))
    layer = jax.tree.map(lambda a: a[0], jp["layers"])
    want = jax.jit(lambda x, p, s, c: jssm.mamba_decode_block(x, p, jm.cfg, s, c))(
        jx, layer, ssm, jc)
    got = tssm.mamba_decode_block(tx, tp["layers"][0], cfg, torch.from_numpy(ssm), tc)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.bfloat16]
    _close(got[0], want[0], BF16)
    _close(got[1], want[1], F32)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


def test_decode_matches_chunked_forward():
    """Token-by-token decode reproduces the chunked block (the port's own
    mirror of tests/test_layers_property.py:92, at its bar: the two forms
    round bf16 at different places)."""
    cfg = tssm.Mamba2Config(name="t", n_layers=1, d_model=32, d_state=8, vocab=64,
                            head_dim=8, chunk=4, remat="none")
    p = tssm.init_mamba_layer(torch.Generator().manual_seed(0), cfg)
    x = (torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(1)) * 0.5
         ).to(torch.bfloat16)
    full = tssm.mamba_block(x, p, cfg)
    ssm = torch.zeros((1, cfg.n_heads, cfg.d_state, cfg.head_dim))
    conv = torch.zeros((1, cfg.conv_width - 1, cfg.conv_channels), dtype=torch.bfloat16)
    outs = []
    for t in range(8):
        o, ssm, conv = tssm.mamba_decode_block(x[:, t:t + 1], p, cfg, ssm, conv)
        outs.append(o)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, dim=1)), rtol=0.05, atol=0.05)


def test_float32_decode_equals_the_chunked_prefill(smoke, monkeypatch):
    """In float32 (the smoke weights cast, embeddings and conv rows float32)
    the two forms of the recurrence agree to float32 rounding: the decode's
    last logits within 1e-5 of the largest |logit| of the chunked prefill's,
    over 48 tokens (three chunks). chip_smoke.py makes the same check at
    full width on the card."""
    from repro_torch.models import common as tcm

    _, _, tm, tp = smoke
    monkeypatch.setattr(tcm, "DEFAULT_DTYPE", torch.float32)
    p32 = {"embed": tp["embed"].float(), "final_norm": tp["final_norm"],
           "layers": [{k: v.float() for k, v in lp.items()} for lp in tp["layers"]]}
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, tm.cfg.vocab, size=(2, 48)))
    pre = tm.prefill(p32, {"tokens": toks})
    cache = tm.init_cache(2, 0, "cpu")
    assert cache["conv"].dtype == torch.float32
    for i in range(toks.shape[1]):
        dec, cache = tm.decode_step(p32, cache, {"tokens": toks[:, i:i + 1], "pos": i})
    assert pre.dtype == torch.float32
    assert float((dec - pre).abs().max()) <= 1e-5 * float(pre.abs().max())


# ------------------------------------------------------------------ model
def test_prefill_matches_repro(smoke):
    jm, jp, tm, tp = smoke
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab, size=(2, 32)).astype(np.int32)
    want = np.asarray(jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}), np.float32)
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, tm.cfg.vocab) and got.dtype == torch.float32
    _close(got, want, _logits_bar(want))
    np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


def test_teacher_forced_decode_matches_repro(smoke):
    """One token sequence through decode_step in both packages from a cache
    that `repro` filled and `convert.cache_from_arrays` carried across."""
    jm, jp, tm, tp = smoke
    rng = np.random.default_rng(7)
    b, steps = 2, 10
    toks = rng.integers(0, tm.cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    shapes = jm.init_cache_shape(b, 0)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes,
                          is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    decode = jax.jit(jm.decode_step)
    for i in range(3):  # repro fills the state first
        _, jcache = decode(jp, jcache, {"tokens": jnp.asarray(toks[i]), "pos": jnp.int32(i)})
    tcache = cache_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jcache))
    assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} == {
        k: (s.shape, s.dtype) for k, s in tm.init_cache_shape(b, 0).items()}
    for i in range(3, steps):
        want, jcache = decode(jp, jcache, {"tokens": jnp.asarray(toks[i]), "pos": jnp.int32(i)})
        got, tcache = tm.decode_step(tp, tcache, {"tokens": torch.from_numpy(toks[i]),
                                                  "pos": torch.tensor(i)})
        want = np.asarray(want, np.float32)
        _close(got, want, _logits_bar(want))
        np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))
    _close(tcache["ssm"], jcache["ssm"], F32)


def test_length_refusal(smoke):
    """As in `repro`, a prompt whose length is no multiple of the chunk
    (min(chunk, S)) is refused, not padded: 20 tokens at chunk 16."""
    jm, jp, tm, tp = smoke
    toks = np.zeros((1, 20), np.int32)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(AssertionError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    for s in (8, 16, 48):  # below the chunk, one chunk, three
        assert tm.prefill(tp, {"tokens": torch.zeros((1, s), dtype=torch.long)}).shape == (
            1, 1, tm.cfg.vocab)


def test_config_and_cache_mirror_repro():
    for smoke_ in (False, True):
        jc, tc = jget_model("mamba2-130m", smoke=smoke_).cfg, get_model(
            "mamba2-130m", smoke=smoke_).cfg
        for f in ("n_layers", "d_model", "d_state", "vocab", "head_dim", "expand", "n_groups",
                  "conv_width", "chunk", "norm_eps", "tie_embed", "remat", "sub_quadratic",
                  "d_inner", "n_heads", "conv_channels"):
            assert getattr(tc, f) == getattr(jc, f), (smoke_, f)
        assert tc.param_count() == jc.param_count()
    model = get_model("mamba2-130m", smoke=True)
    with set_mesh_compat(make_host_mesh()):
        jshapes = jget_model("mamba2-130m", smoke=True).init_cache_shape(3, 7)
    for name, s in model.init_cache_shape(3, 7).items():
        assert s.shape == jshapes[name].shape
    assert model.cache_logical() == jget_model("mamba2-130m", smoke=True).cache_logical()
    assert get_model("mamba2-130m").param_count() == 128_983_488
