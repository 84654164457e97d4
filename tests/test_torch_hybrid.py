"""The port's hybrid (zamba2-2.7b) on the CPU, held against `repro`.

Every comparison runs `jax.jit` of `repro`'s function on the same numpy
inputs; parameters are `repro`'s `init_params(PRNGKey(0))` crossed by
`convert`. "flash" on the CPU is the flash kernel's plain version.

Tolerances, and why:
  * the shared block (bf16): rtol 1/128, one bf16 step, and an atol of 4
    bf16 steps at the block output's largest |value|. Both sides round to
    bf16 at the same places, but XLA's dot and PyTorch's CPU matmul sum
    their products in different orders (and XLA feeds the second norm the
    unrounded h + attn), so a value near a rounding boundary lands one step
    apart, and such a flip moves the products after it by a few steps of
    their own magnitude, which near-zero outputs share;
  * KV rows the block writes: the same bar;
  * logits: 4 bf16 steps at the largest |logit| (tests/test_torch_lm.py),
    and the argmax equal on every row whose top-2 gap is above twice that
    bar (a near-tie may go either way);
  * the float32 ssm state after the decode: the block bar, since bf16
    inputs a step apart drive its recurrence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh, set_mesh_compat
from repro.models import hybrid as jhyb
from repro.models.registry import get_model as jget_model
from repro_torch.convert import cache_from_arrays, params_from_arrays
from repro_torch.kernels import ref
from repro_torch.models import hybrid as thyb
from repro_torch.models.registry import get_model

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _steps(want, n=4):
    """n bf16 steps at the largest |want|: a value in [2^e, 2^(e+1)) moves
    in steps of 2^(e-7)."""
    top = float(np.abs(_np(want)).max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


def _logits_bar(want):
    return dict(rtol=0, atol=_steps(want))


def _block_bar(want):
    return dict(rtol=1 / 128, atol=_steps(want))


def _argmax_agrees(got, want):
    """The argmax is equal on each row whose top-2 gap exceeds twice the
    logits bar."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * _steps(want)
    agree = _np(got).argmax(-1) == want.argmax(-1)
    assert agree[decided].all(), (agree, decided)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _zeros(shapes):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes,
                        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


@pytest.fixture(scope="module")
def smoke():
    jm = jget_model("zamba2-2.7b", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model("zamba2-2.7b", smoke=True)
    tp = params_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    return jm, jp, tm, tp


def test_converted_layers_are_the_stacks(smoke):
    """Site i, layer j of the port is repro's stack entry [i, j]; the shared
    block's leaves are repro's; norms float32, all else bf16."""
    jm, jp, tm, tp = smoke
    cfg = tm.cfg
    assert len(tp["layers"]) == cfg.n_super and all(len(s) == cfg.shared_every
                                                    for s in tp["layers"])
    for i in range(cfg.n_super):
        for j in range(cfg.shared_every):
            for name, t in tp["layers"][i][j].items():
                np.testing.assert_array_equal(_np(t), np.asarray(jp["layers"][name][i, j],
                                                                 np.float32))
    for name, t in tp["shared"].items():
        np.testing.assert_array_equal(_np(t), np.asarray(jp["shared"][name], np.float32))
        assert t.dtype == (torch.float32 if name.startswith("ln") else torch.bfloat16)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_shared_block_prefill_matches_repro(smoke, impl):
    jm, jp, tm, tp = smoke
    rng = np.random.default_rng(1)
    d = tm.cfg.d_model
    (jx, tx), (jx0, tx0) = (_bf16(rng.standard_normal((2, 16, d), dtype=np.float32))
                            for _ in range(2))
    jpos, tpos = jnp.arange(16)[None, :], torch.arange(16)[None, :]
    want, _ = jax.jit(lambda x, x0, p: jhyb._shared_block(x, x0, p, jm.cfg, jpos, "dense"))(
        jx, jx0, jp["shared"])
    calls = ref.FLASH_CALLS
    got = thyb._shared_block(tx, tx0, tp["shared"], tm.cfg, tpos, impl)
    assert ref.FLASH_CALLS - calls == (impl == "flash")
    assert got.dtype == torch.bfloat16
    _close(got, want, _block_bar(want))


@pytest.mark.parametrize("vector_pos", [False, True], ids=["scalar-pos", "vector-pos"])
def test_shared_block_decode_matches_repro(smoke, vector_pos):
    """One decode step of the block against a half-filled cache: the new row
    is written at pos (each slot's own with a [B] pos) and attended with
    valid length pos + 1."""
    jm, jp, tm, tp = smoke
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    b, t = 3, 8
    (jx, tx), (jx0, tx0) = (_bf16(rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32))
                            for _ in range(2))
    kv = [rng.standard_normal((b, t, cfg.n_kv_heads, cfg.head_dim), dtype=np.float32)
          for _ in range(2)]
    pos = np.array([2, 5, 7], np.int32) if vector_pos else np.int32(4)
    positions = np.broadcast_to(np.reshape(pos, (-1, 1)), (b, 1)).astype(np.int32)
    jkv = tuple(_bf16(a)[0] for a in kv)
    tkv = tuple(_bf16(a)[1] for a in kv)
    want, (wk, wv) = jax.jit(lambda x, x0, p, c, ps, pp: jhyb._shared_block(
        x, x0, p, jm.cfg, ps, "dense", cache=c, pos=pp))(
        jx, jx0, jp["shared"], jkv, jnp.asarray(positions), jnp.asarray(pos))
    got = thyb._shared_block(tx, tx0, tp["shared"], cfg, torch.from_numpy(positions), "dense",
                             cache=tkv, pos=torch.from_numpy(np.asarray(pos)))
    _close(got, want, _block_bar(want))
    _close(tkv[0], wk, _block_bar(wk))  # written in place
    _close(tkv[1], wv, _block_bar(wv))
    rows = np.arange(b), np.broadcast_to(pos, (b,))
    untouched = np.ones((b, t), bool)
    untouched[rows] = False
    np.testing.assert_array_equal(_np(tkv[0])[untouched], _np(jkv[0])[untouched])


@pytest.mark.parametrize("impl", ["dense", "flash", "blockwise", "auto"])
def test_prefill_matches_repro(smoke, impl):
    jm, jp, tm, tp = smoke
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab, size=(2, 32)).astype(np.int32)
    dense = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, attn_impl="dense"))
    want = np.asarray(jax.jit(dense.prefill)(jp, {"tokens": jnp.asarray(toks)}), np.float32)
    calls = ref.FLASH_CALLS
    got = tm.with_cfg(attn_impl=impl).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert ref.FLASH_CALLS - calls == (tm.cfg.n_super if impl == "flash" else 0)
    assert got.shape == (2, 1, tm.cfg.vocab) and got.dtype == torch.float32
    _close(got, want, _logits_bar(want))
    _argmax_agrees(got, want)


def test_teacher_forced_decode_from_a_carried_cache(smoke):
    """repro fills ssm, conv and KV for a few steps; `cache_from_arrays`
    carries its cache across; both packages then decode the same tokens,
    slots at their own positions."""
    jm, jp, tm, tp = smoke
    rng = np.random.default_rng(4)
    b, cache_len, steps = 2, 16, 11
    toks = rng.integers(0, tm.cfg.vocab, size=(steps, b, 1)).astype(np.int32)
    offsets = np.array([0, 3])
    jcache = _zeros(jm.init_cache_shape(b, cache_len))
    decode = jax.jit(jm.decode_step)

    def jstep(cache, i):
        return decode(jp, cache, {"tokens": jnp.asarray(toks[i]),
                                  "pos": jnp.asarray((i + offsets).astype(np.int32))})

    for i in range(4):
        _, jcache = jstep(jcache, i)
    tcache = cache_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jcache))
    assert set(tcache) == {"ssm", "conv", "k", "v"}
    np.testing.assert_array_equal(_np(tcache["k"]), np.asarray(jcache["attn"][0], np.float32))
    for i in range(4, steps):
        want, jcache = jstep(jcache, i)
        got, tcache = tm.decode_step(tp, tcache, {
            "tokens": torch.from_numpy(toks[i]), "pos": torch.from_numpy(i + offsets)})
        want = np.asarray(want, np.float32)
        _close(got, want, _logits_bar(want))
        _argmax_agrees(got, want)
    _close(tcache["ssm"], jcache["ssm"], _block_bar(jcache["ssm"]))


def test_decode_vector_pos_matches_scalar(smoke):
    """The mirror of tests/test_serve_slots.py:64 on the hybrid: a [B] pos of
    one value gives the scalar pos's logits and cache, KV rows written only
    at that position."""
    _, _, tm, tp = smoke
    toks = torch.tensor([[3], [5]])
    a_logits, a_cache = tm.decode_step(tp, tm.init_cache(2, 8, "cpu"),
                                       {"tokens": toks, "pos": torch.tensor(2)})
    b_logits, b_cache = tm.decode_step(tp, tm.init_cache(2, 8, "cpu"),
                                       {"tokens": toks, "pos": torch.tensor([2, 2])})
    assert torch.equal(a_logits, b_logits)
    for name in a_cache:
        assert torch.equal(a_cache[name], b_cache[name]), name
    for name in ("k", "v"):
        assert a_cache[name][:, :, 2].abs().sum() > 0
        assert a_cache[name][:, :, :2].abs().sum() == 0 and a_cache[name][:, :, 3:].abs().sum() == 0


def test_config_and_cache_mirror_repro():
    for smoke_ in (False, True):
        jc, tc = jget_model("zamba2-2.7b", smoke=smoke_).cfg, get_model(
            "zamba2-2.7b", smoke=smoke_).cfg
        for f in ("n_layers", "d_model", "d_state", "vocab", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "shared_every", "rope_theta", "norm_eps", "chunk",
                  "remat", "attn_impl", "sub_quadratic", "tie_embed", "n_super"):
            assert getattr(tc, f) == getattr(jc, f), (smoke_, f)
        assert dataclasses.asdict(tc.mamba) == dataclasses.asdict(jc.mamba)
        assert tc.param_count() == jc.param_count()
    full = get_model("zamba2-2.7b").cfg
    assert (full.mamba.n_heads, full.mamba.head_dim, full.n_heads, full.head_dim) == (80, 64,
                                                                                      32, 80)
    model = get_model("zamba2-2.7b", smoke=True)
    with set_mesh_compat(make_host_mesh()):
        jm = jget_model("zamba2-2.7b", smoke=True)
        jshapes = jm.init_cache_shape(3, 7)
    shapes = model.init_cache_shape(3, 7)
    assert shapes["ssm"].shape == jshapes["ssm"].shape
    assert shapes["conv"].shape == jshapes["conv"].shape
    assert shapes["k"].shape == shapes["v"].shape == jshapes["attn"][0].shape
    logical = model.cache_logical()
    jlogical = jm.cache_logical()
    assert (logical["ssm"], logical["conv"]) == (jlogical["ssm"], jlogical["conv"])
    assert logical["k"] == logical["v"] == jlogical["attn"][0]
    with pytest.raises(ValueError, match="attn_impl"):
        model.with_cfg(attn_impl="flash_pallas").init_params(torch.Generator())
