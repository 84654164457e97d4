"""The port's flash attention on the CPU, held against the JAX package.

`repro`'s Pallas kernel (`repro/kernels/flash_attention.py`) cannot run on
this tree's JAX (0.9.0 has no `jax.experimental.pallas.load`), so its own
reference, `repro.models.common.dense_attention` (what
tests/test_kernel_flash.py holds the kernel to), is the yardstick here, with
`blockwise_attention` beside it. On the CPU, `repro_torch.kernels.ops.
flash_attention` runs the kernel's plain version, `flash_attention_ref`; the
CUDA kernel itself is held to that plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).

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
