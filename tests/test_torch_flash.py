"""The port's flash attention on the CPU, held against the JAX package.

`repro`'s Pallas kernel (`repro/kernels/flash_attention.py`) cannot run on
this tree's JAX (0.9.0 has no `jax.experimental.pallas.load`), so its own
reference, `repro.models.common.dense_attention` (what
tests/test_kernel_flash.py holds the kernel to), is the yardstick here, with
`blockwise_attention` beside it. On the CPU, `repro_torch.kernels.ops.
flash_attention` runs the kernel's plain version, `flash_attention_ref`; the
CUDA kernel itself is held to that plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py). What the CPU can say about the
kernels' own roundings, it says through torch emulations of them: bf16
products with p as bf16 hi + lo for the bf16 kernel, 3xTF32 products for the
float32 one (with the cheaper TF32 splits shown to miss the float32 bar).

Inputs come from numpy seeds and reach both packages as the same arrays.
Bars are those of tests/test_kernel_flash.py: float32 rtol 3e-4 / atol 3e-5
(`:31`), bfloat16 0.05 (`:64-65`: one side keeps p in float32, the other
rounds it to bf16), block-size invariance 1e-4 / 1e-5 (`:56`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32 = dict(rtol=3e-4, atol=3e-5)
BF16 = dict(rtol=0.05, atol=0.05)


def _qkv(b, s, h, kh, d, t=None, seed=0):
    t = t or s
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, t, kh, d), dtype=np.float32),
            rng.standard_normal((b, t, kh, d), dtype=np.float32))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,s,h,kh,d", [
    (1, 64, 2, 2, 16),   # MHA
    (2, 64, 4, 2, 16),   # GQA
    (1, 128, 4, 1, 32),  # MQA
])
def test_ref_matches_dense_causal(b, s, h, kh, d):
    arrays = _qkv(b, s, h, kh, d, seed=s + h)
    want = jcm.dense_attention(*_jax(arrays), causal=True)
    got = ref.flash_attention_ref(*_torch(arrays), causal=True, kv_block=32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    via_ops = ops.flash_attention(*_torch(arrays), causal=True)
    np.testing.assert_allclose(_np(via_ops), _np(want), **F32)


def test_ref_window_and_softcap():
    arrays = _qkv(1, 64, 2, 2, 16, seed=3)
    want = jcm.dense_attention(*_jax(arrays), causal=True, window=16, attn_softcap=30.0)
    got = ops.flash_attention(*_torch(arrays), causal=True, window=16, softcap=30.0)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_ref_non_causal_cross_length():
    arrays = _qkv(1, 24, 2, 2, 16, t=40, seed=5)
    want = jcm.dense_attention(*_jax(arrays), causal=False)
    got = ops.flash_attention(*_torch(arrays), causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_ref_block_size_invariance():
    arrays = _qkv(1, 64, 2, 2, 16, seed=7)
    a = ref.flash_attention_ref(*_torch(arrays), kv_block=16)
    bb = ref.flash_attention_ref(*_torch(arrays), kv_block=32)
    np.testing.assert_allclose(_np(a), _np(bb), rtol=1e-4, atol=1e-5)


def test_ref_bf16_inputs():
    arrays = _qkv(1, 64, 4, 2, 16, seed=9)
    want = jcm.dense_attention(*_jax(arrays, jnp.bfloat16), causal=True)
    got = ops.flash_attention(*_torch(arrays, torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("causal,window,cap,s,t", [
    (True, None, None, 64, 64),
    (True, 16, 30.0, 64, 64),
    (False, None, None, 24, 40),
])
def test_ref_matches_blockwise(causal, window, cap, s, t):
    """repro's pure-JAX online softmax, blocks of 16 keys and queries."""
    arrays = _qkv(2, s, 4, 2, 16, t=t, seed=11)
    want = jcm.blockwise_attention(*_jax(arrays), causal=causal, window=window,
                                   attn_softcap=cap, q_block=8, kv_block=8)
    got = ops.flash_attention(*_torch(arrays), causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ref_gemma_2b_like_mqa_head_dim_256(dtype):
    """gemma-2b's attention shape cut in length: 8 query heads, one kv head, D 256."""
    arrays = _qkv(2, 96, 8, 1, 256, seed=13)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jcm.dense_attention(*_jax(arrays, jd), causal=True)
    got = ops.flash_attention(*_torch(arrays, td), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **(F32 if dtype == "f32" else BF16))


@pytest.mark.parametrize("s,t,causal", [(77, 77, True), (50, 77, False), (131, 131, True)])
def test_ref_ragged_lengths(s, t, causal):
    """Lengths that are no multiple of the kv block: the last block is partial."""
    arrays = _qkv(1, s, 4, 2, 32, t=t, seed=s)
    want = jcm.dense_attention(*_jax(arrays), causal=causal)
    got = ref.flash_attention_ref(*_torch(arrays), causal=causal, kv_block=32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_fully_masked_rows_are_zero():
    """With no key allowed, the kernel writes 0 (l clamped at 1e-30); dense
    attention would average uniformly, so only the other rows compare."""
    arrays = _qkv(1, 64, 2, 1, 32, t=8, seed=17)
    got = _np(ops.flash_attention(*_torch(arrays), causal=False, window=16))
    dead = np.arange(64) - 7 >= 16
    assert dead.sum() == 41 and (got[:, dead] == 0).all()
    want = _np(jcm.dense_attention(*_jax(arrays), causal=False, window=16))
    np.testing.assert_allclose(got[:, ~dead], want[:, ~dead], **F32)


def test_cpu_dispatch_goes_to_the_plain_version():
    arrays = _torch(_qkv(1, 16, 2, 1, 16))
    launches, calls = fa.LAUNCHES, ref.FLASH_CALLS
    ops.flash_attention(*arrays)
    assert (fa.LAUNCHES, ref.FLASH_CALLS) == (launches, calls + 1)


def test_kernel_wrapper_refuses_cpu_and_unsupported_tensors():
    q, k, v = _torch(_qkv(1, 16, 2, 1, 16))
    launches = fa.LAUNCHES
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention_kernel(q.half(), k.half(), v.half())
    big = _torch(_qkv(1, 16, 2, 1, 288))
    with pytest.raises(ValueError, match="head dim 288"):
        fa.flash_attention_kernel(*big)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_kernel(*_torch(_qkv(1, 16, 3, 2, 16)))
    with pytest.raises(ValueError, match="window"):
        fa.check_args(q, k, v, window=0, softcap=None)
    with pytest.raises(ValueError, match="softcap"):
        fa.check_args(q, k, v, window=None, softcap=0.0)
    assert fa.LAUNCHES == launches


@pytest.mark.parametrize("s,t,causal", [
    (64, 64, True), (24, 40, True), (64, 8, True), (24, 40, False),
])
def test_attention_flops_counts_allowed_pairs(s, t, causal):
    qpos, kpos = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok &= kpos <= qpos
    assert fa.attention_flops(2, s, t, 3, 16, causal=causal) == \
        4 * 16 * int(ok.sum()) * 2 * 3


# ------------------------------------------------- the tensor-core route's numerics
#: the bars of the bf16 kernel against its plain version on the card
#: (chip_smoke.py FLASH_BARS, tests/test_torch_gpu.py FLASH_BARS)
BF16_KERNEL_BAR = dict(rtol=2**-7, atol=3e-5)
LOG2E = 1.4426950408889634
BK = 64  # keys a tile of csrc/flash_attention_wgmma.cu


def _tensor_core_emulation(q, k, v, *, causal, window, softcap):
    """What csrc/flash_attention_wgmma.cu rounds, in torch on the CPU: bf16 q,
    k, v with the head dimension padded with zeros to 64, 128 or 256; per
    tile of 64 keys, q . k in float32 (the bf16 products are exact) times
    scale * log2(e) after the product (soft-capped in natural units first);
    the online softmax in the log2 domain in float32; p split into bf16 hi
    and lo = bf16(p - hi), both multiplied into the same bf16 V and summed
    in float32; the output rounded once to bf16. Returns (o, padded o)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    c2 = scale * torch.tensor(LOG2E, dtype=torch.float32)

    def padded(t, rep=1):
        t = torch.nn.functional.pad(t.float(), (0, dp - d))
        return t.repeat_interleave(rep, dim=2).transpose(1, 2)

    qf, kf, vf = padded(q), padded(k, h // kh), padded(v, h // kh)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -1e30)
    l_sum = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, dp))
    for k0 in range(0, skv, BK):
        s = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
        if softcap is not None:
            x = softcap * torch.tanh(s * scale / softcap) * LOG2E
        else:
            x = s * c2
        kpos = torch.arange(k0, min(k0 + BK, skv))[None, :]
        ok = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        x = torch.where(ok, x, -1e30)
        m_new = torch.maximum(m, x.amax(dim=-1))
        p = torch.where(ok, torch.exp2(x - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + BK]
        acc = acc * corr[..., None] + hi @ vt + lo @ vt
        m = m_new
    out = (acc / torch.clamp(l_sum, min=1e-30)[..., None]).transpose(1, 2)
    return out[..., :d].to(torch.bfloat16), out


def _emulation_cases():
    """tests/test_torch_gpu.py's FLASH_CASES but gemma-2b's full prefill
    (4 x 2048), whose rows are those of the ragged 2047 case four times over."""
    from test_torch_gpu import FLASH_CASES

    return [c for c in FLASH_CASES if c[:2] != (4, 2048)]


@pytest.mark.parametrize("case", _emulation_cases(), ids=lambda c: "-".join(map(str, c)))
def test_tensor_core_roundings_meet_the_bars(case):
    """The bf16 tensor-core route's roundings (bf16 products, hi + lo p)
    within the card's bf16 kernel bar of the plain version, within the 0.05
    bar of repro's dense attention, with zero padded head columns and rows
    with no allowed key at 0."""
    b, sq, h, kh, d, skv, causal, window, cap = case
    arrays = _qkv(b, sq, h, kh, d, t=skv, seed=sq + h)
    q, k, v = _torch(arrays, torch.bfloat16)
    got, padded = _tensor_core_emulation(q, k, v, causal=causal, window=window, softcap=cap)
    assert bool((padded[..., d:] == 0).all())
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(plain), **BF16_KERNEL_BAR)
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    alive = ok.any(axis=1)
    assert (_np(got)[:, ~alive] == 0).all()
    want = jcm.dense_attention(*_jax(arrays, jnp.bfloat16), causal=causal, window=window,
                               attn_softcap=cap)
    np.testing.assert_allclose(_np(got)[:, alive], _np(want)[:, alive], **BF16)


# ------------------------------------------- the float32 (3xTF32) route's numerics
F32_BK = 32  # keys a tile of csrc/flash_attention_tf32.cu


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away from
    zero, on the 10-bit mantissa; the low 13 bits of the float32 word are 0."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def _split(x):
    """x as TF32 hi + lo, the kernel's split: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_product(a, b, terms, a_lo_bf16=False):
    """a @ b in float32 from TF32 pieces: "1" one pass (a_hi b_hi), "a" or "b"
    two terms with the lo of that factor, "3" 3xTF32 (a_hi b_hi + a_lo b_hi
    + a_hi b_lo). With `a_lo_bf16`, a's lo is a - a_hi rounded to bf16 (the
    kernel keeps q's lo so). Products of TF32 values are exact in float32."""
    ah, al = _split(a)
    if a_lo_bf16:
        al = (a - ah).to(torch.bfloat16).float()
    bh, bl = _split(b)
    out = ah @ bh
    if terms in ("a", "3"):
        out = out + al @ bh
    if terms in ("b", "3"):
        out = out + ah @ bl
    return out


def _tf32_emulation(q, k, v, *, causal, window, softcap, qk="3", pv="3"):
    """What csrc/flash_attention_tf32.cu rounds, in torch on the CPU: q scaled
    in float32 and split into a TF32 hi and a bf16 lo, the head dimension
    padded with zeros to 64, 128 or 256; per tile of 32 keys, s = q . k from
    the TF32 pieces (`qk` terms, `_tf32_product`), soft-capped in natural
    units, then to log2 units; the online softmax in the log2 domain in float32; p . v
    from the TF32 pieces of p and v (`pv` terms) summed in float32 into the
    accumulator; the output acc / max(l, 1e-30). The kernel's own terms are
    "3" for both. Returns (o, padded o)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    scale = float(1.0 / np.sqrt(d))

    def padded(t, rep=1):
        t = torch.nn.functional.pad(t.float(), (0, dp - d))
        return t.repeat_interleave(rep, dim=2).transpose(1, 2)

    qf, kf, vf = padded(q) * scale, padded(k, h // kh), padded(v, h // kh)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -1e30)
    l_sum = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, dp))
    for k0 in range(0, skv, F32_BK):
        s = _tf32_product(qf, kf[:, :, k0:k0 + F32_BK].transpose(-1, -2), qk, a_lo_bf16=True)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        x = s * LOG2E
        kpos = torch.arange(k0, min(k0 + F32_BK, skv))[None, :]
        ok = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        x = torch.where(ok, x, -1e30)
        m_new = torch.maximum(m, x.amax(dim=-1))
        p = torch.where(ok, torch.exp2(x - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _tf32_product(p, vf[:, :, k0:k0 + F32_BK], pv)
        m = m_new
    out = (acc / torch.clamp(l_sum, min=1e-30)[..., None]).transpose(1, 2)
    return out[..., :d], out


def _bar_excess(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|): above 1 fails the bar."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def test_tf32_rounding_is_cvt_rna():
    """Nearest, ties away from zero, carried into the exponent; hi and lo are
    TF32 words whose sum is within 2^-23 of x."""
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11),
                      1.0 + 2**-11 - 2**-23, 2.0 - 2**-12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 1.0, 2.0],
                        dtype=torch.float64)
    assert torch.equal(_tf32(x).double(), want)
    hi, lo = _split(torch.tensor([1.0 / 3.0]))
    assert (hi.view(torch.int32) & 0x1FFF).item() == 0
    assert (lo.view(torch.int32) & 0x1FFF).item() == 0
    assert abs((hi.double() + lo.double()).item() - float(np.float32(1.0 / 3.0))) <= 2.0**-23


@pytest.mark.parametrize("case", _emulation_cases(), ids=lambda c: "-".join(map(str, c)))
def test_tf32_roundings_meet_the_float32_bar(case):
    """The float32 tensor-core route's roundings (3xTF32 on both products,
    tiles of 32 keys, hi rounded to nearest, q's lo in bf16) within the
    float32 bar of the plain version and of repro's dense attention, with
    zero padded head columns and rows with no allowed key at 0."""
    b, sq, h, kh, d, skv, causal, window, cap = case
    arrays = _qkv(b, sq, h, kh, d, t=skv, seed=sq + h)
    q, k, v = _torch(arrays)
    got, padded = _tf32_emulation(q, k, v, causal=causal, window=window, softcap=cap)
    assert bool((padded[..., d:] == 0).all())
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(plain), **F32)
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    alive = ok.any(axis=1)
    assert (_np(got)[:, ~alive] == 0).all()
    want = jcm.dense_attention(*_jax(arrays), causal=causal, window=window, attn_softcap=cap)
    np.testing.assert_allclose(_np(got)[:, alive], _np(want)[:, alive], **F32)


@pytest.mark.parametrize("qk,pv", [("1", "1"), ("3", "1"), ("3", "a"), ("3", "b"),
                                   ("a", "3"), ("b", "3")],
                         ids=["one-pass", "3x-qk-one-pass-pv", "3x-qk-p-split",
                              "3x-qk-v-split", "q-split-3x-pv", "k-split-3x-pv"])
def test_cheaper_tf32_splits_fail_the_float32_bar(qk, pv):
    """Why the kernel pays for three products on both: a single TF32 pass, and
    each split that drops one lo term of a product, lands outside the float32
    bar of the plain version on every case of the emulation."""
    for case in _emulation_cases():
        b, sq, h, kh, d, skv, causal, window, cap = case
        q, k, v = _torch(_qkv(b, sq, h, kh, d, t=skv, seed=sq + h))
        got, _ = _tf32_emulation(q, k, v, causal=causal, window=window, softcap=cap,
                                 qk=qk, pv=pv)
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
        assert _bar_excess(got, plain, **F32) > 1, case


# ------------------------------------------------------------- route by dtype
_ALIGNED = dict(strides=[8 * i for i in range(12)], data_ptrs=[4096, 8192, 12288, 16384])


@pytest.mark.parametrize("d", [16, 72, 256])
def test_route_sends_bf16_and_float32_to_their_tensor_core_kernels(d):
    """The dtype alone picks the kernel; rows of an aligned layout on the
    grid are read in 16-byte pieces."""
    assert fa.route(torch.bfloat16) == fa.TENSOR_CORE
    assert fa.route(torch.float32) == fa.TENSOR_CORE_F32
    assert not fa.staged(torch.bfloat16, d, **_ALIGNED)
    assert not fa.staged(torch.float32, d, **_ALIGNED)


@pytest.mark.parametrize("d", [1, 20, 250])
def test_route_stages_a_head_dim_off_the_8_grid_element_by_element(d):
    """D not a multiple of 8: no 16-byte pieces of bf16, whatever the
    strides and bases."""
    assert fa.staged(torch.bfloat16, d, strides=[d, 3 * d, 5] * 4,
                     data_ptrs=[4098, 8194, 2, 6])
    assert fa.staged(torch.bfloat16, d, **_ALIGNED)


@pytest.mark.parametrize("d", [1, 10, 250])
def test_route_stages_a_float32_head_dim_off_the_4_grid_element_by_element(d):
    """float32 with D not a multiple of 4: no 16-byte pieces, whatever the
    strides and (4-byte aligned) bases."""
    assert fa.staged(torch.float32, d, strides=[d, 3 * d, 5] * 4,
                     data_ptrs=[4100, 8196, 4, 8])
    assert fa.staged(torch.float32, d, **_ALIGNED)


@pytest.mark.parametrize("strides,ptrs,match", [
    ([8] * 11 + [68], [16] * 4, "strides \\[68\\]"),
    ([8] * 12, [16, 18, 32, 48], "bases \\['0x12'\\]"),
])
def test_route_refuses_bf16_rows_that_are_not_16_byte_pieces(strides, ptrs, match):
    """bf16 rows that are not 16-byte pieces (a stride off the 8 grid, a base
    2 bytes past an aligned one) no longer raise: the bf16 kernel takes them
    and stages them element by element, as repro's ops.flash_attention takes
    any layout. The same strides are 16-byte pieces of float32 rows; the
    bases are not."""
    assert fa.staged(torch.bfloat16, 64, strides=strides, data_ptrs=ptrs)
    assert fa.staged(torch.float32, 64, strides=strides, data_ptrs=ptrs) == \
        any(p % 16 for p in ptrs), match


@pytest.mark.parametrize("strides,ptrs,match", [
    ([4] * 11 + [66], [16] * 4, "strides \\[66\\]"),
    ([4] * 12, [16, 20, 32, 48], "bases \\['0x14'\\]"),
])
def test_route_refuses_float32_rows_that_are_not_16_byte_pieces(strides, ptrs, match):
    """float32 rows that are not 16-byte pieces are staged element by
    element (and so are they in bf16)."""
    assert fa.staged(torch.float32, 64, strides=strides, data_ptrs=ptrs), match
    assert fa.staged(torch.bfloat16, 64, strides=strides, data_ptrs=ptrs)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 20),
                                     (torch.float32, 64), (torch.float32, 10)])
def test_route_stages_rows_of_a_q_sliced_at_an_odd_offset(dtype, d):
    """A q sliced one element past an aligned base: every base but q's is
    aligned and every stride on the grid, and the call is staged all the
    same; the aligned call is staged only when D is off the grid."""
    grid = 16 // torch.empty((), dtype=dtype).element_size()
    strides = [4 * 8 * d, 8 * d, d] * 4
    ptrs = [4096, 8192, 12288, 16384]
    assert fa.staged(dtype, d, strides, ptrs) == bool(d % grid)
    odd = [4096 + torch.empty((), dtype=dtype).element_size()] + ptrs[1:]
    assert fa.staged(dtype, d, strides, odd)


def test_route_refuses_other_dtypes():
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            fa.route(dtype)
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            fa.staged(dtype, 64, **_ALIGNED)
