"""Shared neural layers of the decoder (PyTorch).

Counterpart of `repro.models.common`, for what the decoder needs: norms,
soft-capping, RoPE, attention (dense, blockwise, one-token decode and the
router that adds the flash kernel), the gated MLP, the int8 KV-cache
quantization, the embedding, the training loss (`cross_entropy_loss`,
`cross_entropy_chunked`) and the configs' rematerialization (`remat`);
and for the NPE estimator's trunk (`core/npe.py`) and the encoder-decoder,
`layer_norm` and `vanilla_mlp`.

Conventions kept from `repro`: activations and matrices bf16, norms,
softmax and RoPE angles float32; attention takes q [B, S, H, D] and k, v
[B, T, KH, D] with H = KH * G.

The query scale follows JAX's type promotion exactly. With `scale=None` the
scale is 1/sqrt(D) as a float64 numpy scalar, a strong type, so JAX
promotes q to float32 and the scores are float32 products; a Python float
scale is weakly typed, is cast to q's dtype, and a bf16 q stays bf16 (its
scores are then rounded to bf16 before they are cast to float32).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

DEFAULT_DTYPE = torch.bfloat16

NEG_INF = -1e30


# ----------------------------------------------------------------- init utils
def ninit(generator: torch.Generator, shape, fan_in=None, dtype=DEFAULT_DTYPE,
          device=None) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), drawn in float32 on `device`
    (the generator's device by default), then cast to `dtype`."""
    fan_in = fan_in or shape[0]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    device = generator.device if device is None else device
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)
    return (x * float(std)).to(dtype)


# ----------------------------------------------------------------- norms etc.
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """`repro`'s layer norm: the mean, the population variance (`jnp.var`),
    then rsqrt(var + eps), all in float32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(
        torch.float32)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap), in float32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ----------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, halves layout. x [B, S, H, D] (D even), positions
    [B, S] or [S]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freq  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention
def scale_query(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """q * scale with JAX's promotion: float32 for the default 1/sqrt(D),
    q's dtype for a given Python float (see the module docstring)."""
    if scale is None:
        return q.to(torch.float32) * float(1.0 / np.sqrt(q.shape[-1]))
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _score_mod(s, cap):
    return softcap(s, cap) if cap is not None else s


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Reference attention, materializes [.., S, T]. For short sequences."""
    b, sq, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qq = scale_query(q, scale).reshape(b, sq, kh, g, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qq, k.to(qq.dtype)).to(torch.float32)
    s = _score_mod(s, attn_softcap)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(t, device=q.device)
    ok = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    """Online-softmax attention in plain PyTorch: loops over q blocks and KV
    blocks with running (max, denom, acc); never materializes [S, T]. As in
    `repro`, acc is kept in v's dtype."""
    b, sq, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    q_block = min(q_block, sq)
    kv_block = min(kv_block, t)
    if sq % q_block or t % kv_block:
        raise ValueError(f"blocks must divide the lengths: {(sq, q_block, t, kv_block)}")
    qr = scale_query(q, scale).reshape(b, sq, kh, g, d)
    kr = k.to(qr.dtype)
    outs = []
    for q0 in range(0, sq, q_block):
        qblk = qr[:, q0:q0 + q_block]  # [b, qb, kh, g, d]
        qpos = q0 + torch.arange(q_block, device=q.device)
        m = torch.full((b, kh, g, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l_sum = torch.zeros((b, kh, g, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, q_block, d), dtype=v.dtype, device=q.device)
        for k0 in range(0, t, kv_block):
            kblk, vblk = kr[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block]
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk).to(torch.float32)
            s = _score_mod(s, attn_softcap)
            kpos = k0 + torch.arange(kv_block, device=q.device)
            ok = torch.ones((q_block, kv_block), dtype=torch.bool, device=q.device)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                ok &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        outs.append(acc / torch.clamp(l_sum, min=1e-30)[..., None].to(acc.dtype))
    out = torch.stack(outs, dim=1)  # [b, nq, kh, g, q_block, d]
    out = out.permute(0, 1, 4, 2, 3, 5)  # [b, nq, q_block, kh, g, d]
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, T, KH, D]
    v_cache: torch.Tensor,
    *,
    valid_len: Optional[torch.Tensor] = None,  # [B] or None = full cache valid
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against a KV cache."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qq = scale_query(q, scale).reshape(b, kh, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qq, k_cache.to(qq.dtype)).to(torch.float32)
    s = _score_mod(s, attn_softcap)
    kpos = torch.arange(t, device=q.device)
    if valid_len is not None:
        valid_len = valid_len.to(q.device)
        ok = kpos[None, :] < valid_len[:, None]  # [B, T]
        if window is not None:
            ok &= kpos[None, :] >= valid_len[:, None] - window
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
    elif window is not None:
        s = torch.where((kpos >= t - window)[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


ATTN_IMPLS = ("auto", "dense", "blockwise", "flash")


def attention(q, k, v, *, impl: str = "auto", **kw):
    """Route to an attention implementation. "flash" is the port's name for
    `repro`'s "flash_pallas": the CUDA kernel on the card, its plain version
    on the CPU (`repro_torch.kernels.ops.flash_attention`)."""
    if impl == "auto":
        impl = "blockwise" if q.shape[1] * k.shape[1] > 2048 * 2048 else "dense"
    if impl == "dense":
        return dense_attention(q, k, v, **kw)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, **kw)
    if impl == "flash":
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.flash_attention(
            q, k, v,
            causal=kw.get("causal", True),
            window=kw.get("window"),
            softcap=kw.get("attn_softcap"),
            scale=kw.get("scale"),
        )
    raise ValueError(f"attn impl {impl!r} is not one of {ATTN_IMPLS}")


# ------------------------------------------------------------------------ MLP
def gated_mlp(x, wg, wu, wd, act: str = "silu"):
    """SwiGLU/GeGLU feed-forward: act(x@wg) * (x@wu) @ wd."""
    a = x @ wg
    if act == "silu":
        a = F.silu(a.to(torch.float32)).to(x.dtype)
    elif act == "gelu":
        a = F.gelu(a.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return (a * (x @ wu)) @ wd


def vanilla_mlp(x, w1, b1, w2, b2):
    """Plain GELU MLP: the tanh GELU, as `jax.nn.gelu` defaults to
    (`approximate=True`), in float32."""
    a = F.gelu((x @ w1 + b1).to(torch.float32), approximate="tanh")
    return (a.to(x.dtype) @ w2 + b2.to(x.dtype)).to(x.dtype)


# ----------------------------------------------------------- KV quantization
#: float32 1/127 and 1e-12, the constants of the scale as XLA compiles it
_INV_127 = float(np.float32(1.0 / 127.0))
_EPS_12 = float(np.float32(1e-12))


def kv_quantize(x: torch.Tensor):
    """Symmetric int8 quantization a (token, head): x [B, S, K, D] ->
    (int8 [B, S, K, D], float32 scale [B, S, K, 1]). The scale is
    max|x| / 127 + 1e-12; values round half to even and clip to +-127.

    `repro` runs it compiled, where XLA turns the division by 127 into a
    product with float32 1/127 and fuses it with the add: the scale is
    fma(max|x|, f32(1/127), f32(1e-12)), one rounding. The product of two
    float32 values is exact in float64, so the float64 sum rounded to
    float32 gives the same value."""
    xf = x.to(torch.float32)
    top = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = (top.to(torch.float64) * _INV_127 + _EPS_12).to(torch.float32)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


# ------------------------------------------------------------------ embedding
def embed(tokens: torch.Tensor, table: torch.Tensor, scale_by_dim: bool = False):
    x = table[tokens]
    if scale_by_dim:
        # repro multiplies by np.sqrt(d), a float64 numpy scalar: float32 product
        x = x.to(torch.float32) * float(np.sqrt(table.shape[1]))
    return x.to(DEFAULT_DTYPE)


def unembed(x: torch.Tensor, table: torch.Tensor, logit_cap: Optional[float] = None):
    logits = torch.einsum("bsd,vd->bsv", x, table.to(x.dtype)).to(torch.float32)
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    return logits


def last_token_logits(x: torch.Tensor, table: torch.Tensor, logit_cap=None) -> torch.Tensor:
    """Serving prefill output: next-token logits [B, 1, V] only."""
    return unembed(x[:, -1:], table, logit_cap)


# ---------------------------------------------------------------------- loss
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy. logits [B, S, V] float32, labels [B, S]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.long))[..., 0]
    return torch.mean(logz - gold)


def _pick_chunk(s: int, target: int = 1024) -> int:
    for c in (target, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if c <= s and s % c == 0:
            return c
    return s


def _chunk_ce_sum(xc, table, lc, logit_cap):
    logits = unembed(xc, table, logit_cap)  # [B, c, V] float32, one chunk
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].to(torch.long))[..., 0]
    return torch.sum(logz - gold)


def cross_entropy_chunked(
    x: torch.Tensor,  # [B, S, d] final features
    table: torch.Tensor,  # [V, d] unembedding
    labels: torch.Tensor,  # [B, S]
    logit_cap: Optional[float] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Mean cross entropy without the whole [B, S, V] float32 logits: the
    unembedding and logsumexp run a sequence chunk at a time (`_pick_chunk`:
    the largest of 1024, 512, ... that divides S), each chunk checkpointed
    as `repro`'s `jax.checkpoint` does, so that autograd keeps one [B, chunk,
    V] slab at a time and not one a chunk. The chunk sums add up in float32
    in order, then divide by B * S."""
    b, s, _ = x.shape
    c = _pick_chunk(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()
    for c0 in range(0, s, c):
        xc, lc = x[:, c0:c0 + c], labels[:, c0:c0 + c]
        if grad:
            part = torch_checkpoint.checkpoint(_chunk_ce_sum, xc, table, lc, logit_cap,
                                               use_reentrant=False)
        else:
            part = _chunk_ce_sum(xc, table, lc, logit_cap)
        total = total + part
    return total / (b * s)


# --------------------------------------------------------------------- remat
REMAT_POLICIES = ("none", "dots", "full")

#: the products `"dots"` keeps, `repro`'s `dots_with_no_batch_dims_saveable`:
#: matrix products with no batch dimension (a [B, S, d] @ [d, f] product
#: reaches autograd as one `mm` of the flattened rows)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str) -> Callable:
    """`fn` under a config's `remat` policy, as `repro` wraps its scanned
    layer bodies: "none" keeps every activation autograd saves; "full"
    checkpoints the call (its backward runs `fn` again); "dots" also runs it
    again but keeps the outputs of its matrix products
    (`torch.utils.checkpoint.create_selective_checkpoint_contexts`). Remat
    moves memory, not values: the gradients are the same bits. With no
    gradient to take (serving), `fn` runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat {policy!r} is not one of {REMAT_POLICIES}")
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped
