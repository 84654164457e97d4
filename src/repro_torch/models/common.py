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


class Blockwise:
    """The pieces of `blockwise_attention`'s two loops over one (q, k, v):
    `start(q0)` a q block's running state, `kv_step(state, k0)` one KV
    block folded into it, `end(state)` the block's output, `finish(outs)`
    the outputs of every q block (`q_starts`) as [B, S, H, D]."""

    def __init__(self, q, k, v, *, causal=True, window=None, attn_softcap=None, scale=None,
                 q_block=512, kv_block=512):
        b, sq, h, d = q.shape
        t, kh = k.shape[1], k.shape[2]
        g = h // kh
        q_block = min(q_block, sq)
        kv_block = min(kv_block, t)
        if sq % q_block or t % kv_block:
            raise ValueError(f"blocks must divide the lengths: {(sq, q_block, t, kv_block)}")
        self.q, self.v, self.causal, self.window, self.softcap = q, v, causal, window, attn_softcap
        self.shape, self.g, self.kh = (b, sq, h, d), g, kh
        self.q_block, self.kv_block = q_block, kv_block
        self.q_starts, self.kv_starts = range(0, sq, q_block), range(0, t, kv_block)
        self.qr = scale_query(q, scale).reshape(b, sq, kh, g, d)
        self.kr = k.to(self.qr.dtype)

    def start(self, q0):
        b, _, _, d = self.shape
        kh, g, qb, dev = self.kh, self.g, self.q_block, self.q.device
        qblk = self.qr[:, q0:q0 + qb]  # [b, qb, kh, g, d]
        qpos = q0 + torch.arange(qb, device=dev)
        return (qblk, qpos,
                torch.full((b, kh, g, qb), NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros((b, kh, g, qb), dtype=torch.float32, device=dev),
                torch.zeros((b, kh, g, qb, d), dtype=self.v.dtype, device=dev))

    def kv_step(self, state, k0):
        qblk, qpos, m, l_sum, acc = state
        kvb, dev = self.kv_block, self.q.device
        kblk, vblk = self.kr[:, k0:k0 + kvb], self.v[:, k0:k0 + kvb]
        s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk).to(torch.float32)
        s = _score_mod(s, self.softcap)
        kpos = k0 + torch.arange(kvb, device=dev)
        ok = torch.ones((self.q_block, kvb), dtype=torch.bool, device=dev)
        if self.causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if self.window is not None:
            ok &= qpos[:, None] - kpos[None, :] < self.window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vblk.dtype), vblk)
        return qblk, qpos, m_new, l_sum, acc * corr[..., None].to(acc.dtype) + pv

    @staticmethod
    def end(state):
        _, _, _, l_sum, acc = state
        return acc / torch.clamp(l_sum, min=1e-30)[..., None].to(acc.dtype)

    def finish(self, outs):
        b, sq, h, d = self.shape
        out = torch.stack(outs, dim=1)  # [b, nq, kh, g, q_block, d]
        out = out.permute(0, 1, 4, 2, 3, 5)  # [b, nq, q_block, kh, g, d]
        return out.reshape(b, sq, h, d).to(self.q.dtype)


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
    blocks = Blockwise(q, k, v, causal=causal, window=window, attn_softcap=attn_softcap,
                       scale=scale, q_block=q_block, kv_block=kv_block)
    outs = []
    for q0 in blocks.q_starts:
        state = blocks.start(q0)
        for k0 in blocks.kv_starts:
            state = blocks.kv_step(state, k0)
        outs.append(blocks.end(state))
    return blocks.finish(outs)


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
    if is_dtensor(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, valid_len=valid_len,
                                         window=window, attn_softcap=attn_softcap, scale=scale)
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qq = reshape(scale_query(q, scale), b, kh, g, d)
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


def _decode_attention_sharded(q, k_cache, v_cache, *, valid_len=None, window=None,
                              attn_softcap=None, scale=None):
    """`decode_attention` against a DTensor cache whose sequence is split
    over mesh dims (`repro`'s decode layout), on local tensors: each rank
    scores the new token against its rows of the batch and its stretch of
    the sequence, and the softmax's max, its denominator and the weighted
    values add up over the sequence's shards (an all-reduce each, the last
    two in float32), each rank's probabilities rounded to v's dtype before
    the product as one device's are. Returns [B, 1, H, D], laid out as the
    cache's rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k_cache.device_mesh
    cache_lay = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate()
                      for pl in k_cache.placements)
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in cache_lay)
    k = k_cache.redistribute(mesh, cache_lay).to_local()
    v = v_cache.redistribute(mesh, cache_lay).to_local()
    ql = q.redistribute(mesh, rows).to_local()
    seq = [i for i, pl in enumerate(cache_lay) if pl == Shard(1)]
    coord, shard, row_shard = mesh.get_coordinate(), 0, 0
    for i in seq:
        shard = shard * mesh.size(i) + coord[i]
    for i, pl in enumerate(rows):
        if pl == Shard(0):
            row_shard = row_shard * mesh.size(i) + coord[i]
    b, _, h, d = ql.shape
    t, kh = k_cache.shape[1], k.shape[2]
    qq = scale_query(ql, scale).reshape(b, kh, h // kh, d)
    s = torch.einsum("bkgd,btkd->bkgt", qq, k.to(qq.dtype)).to(torch.float32)
    s = _score_mod(s, attn_softcap)
    kpos = shard * k.shape[1] + torch.arange(k.shape[1], device=ql.device)
    if valid_len is not None:
        if is_dtensor(valid_len):
            valid_len = valid_len.full_tensor()
        valid_len = valid_len.to(ql.device)[row_shard * b:(row_shard + 1) * b]
        ok = kpos[None, :] < valid_len[:, None]
        if window is not None:
            ok &= kpos[None, :] >= valid_len[:, None] - window
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
    elif window is not None:
        s = torch.where((kpos >= t - window)[None, None, None, :], s, NEG_INF)
    m = _allreduce(torch.amax(s, dim=-1, keepdim=True), mesh, seq, "max")
    p = torch.exp(s - m)
    denom = _allreduce(p.sum(dim=-1), mesh, seq)
    out = _allreduce(torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype), v).to(torch.float32),
                     mesh, seq)
    out = (out / denom[..., None]).to(v.dtype).reshape(b, 1, h, d)
    return DTensor.from_local(out, mesh, rows, run_check=False)


ATTN_IMPLS = ("auto", "dense", "blockwise", "flash")


def attention(q, k, v, *, impl: str = "auto", **kw):
    """Route to an attention implementation. "flash" is the port's name for
    `repro`'s "flash_pallas": the CUDA kernel on the card, its plain version
    on the CPU (`repro_torch.kernels.ops.flash_attention`)."""
    if impl == "auto":
        impl = "blockwise" if q.shape[1] * k.shape[1] > 2048 * 2048 else "dense"
    if is_dtensor(q):
        return _attention_local_heads(impl, q, k, v, **kw)
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


def _attention_local_heads(impl: str, q, k, v, **kw):
    """`attention` on DTensors: each rank runs the plain route (or the flash
    kernel, whose ctypes call takes no DTensor) on its own rows of the
    batch (over the data axes, where they divide) and its own query heads
    (over "model", where they divide), with the kv heads those query heads
    read (a slice of the kv heads where these do not divide "model"
    themselves; the slice's gradient is then a partial sum over "model").
    Query heads that do not divide "model" are gathered, and every model
    rank computes them all, as `repro`'s layout replicates them. Returns
    the output DTensor laid out as the rank's queries."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    b, _, h, _ = q.shape
    kh = k.shape[2]
    g = h // kh
    names = tuple(mesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    head_dims = [i for i in range(len(names)) if i not in dp]
    n_dp, n_h = 1, 1
    for i in dp:
        n_dp *= mesh.size(i)
    for i in head_dims:
        n_h *= mesh.size(i)
    on_b = Shard(0) if b % n_dp == 0 else Replicate()
    h_loc = h // n_h
    q_split = h % n_h == 0 and (kh % n_h == 0 or h_loc % g == 0 or g % h_loc == 0)
    kv_split = q_split and kh % n_h == 0
    on_q = Shard(2) if q_split else Replicate()
    on_kv = Shard(2) if kv_split else Replicate()
    q_lay = tuple(on_b if i in dp else on_q for i in range(len(names)))
    kv_lay = tuple(on_b if i in dp else on_kv for i in range(len(names)))
    kv_grad = tuple(on_b if i in dp else (Partial() if q_split and not kv_split else on_kv)
                    for i in range(len(names)))
    ql = q.redistribute(mesh, q_lay).to_local()
    kl = k.redistribute(mesh, kv_lay).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kv_lay).to_local(grad_placements=kv_grad)
    if q_split and not kv_split:
        coord, j = mesh.get_coordinate(), 0
        for i in head_dims:
            j = j * mesh.size(i) + coord[i]
        lo = (j * h_loc) // g
        hi = max(lo + 1, ((j + 1) * h_loc) // g)
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    out = attention(ql, kl, vl, impl=impl, **kw)
    return DTensor.from_local(out, mesh, q_lay, run_check=False)


class _PinnedGrad(torch.autograd.Function):
    """The identity on a DTensor whose gradient is laid out as the DTensor:
    left to itself DTensor may hand a backward a strided or partial layout
    that the next view or the gradients' sum cannot take."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        # the gradient of a partial sum is whole on every rank
        ctx.mesh = x.device_mesh
        ctx.layout = tuple(Replicate() if pl.is_partial() else pl for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        moved = [i for i, (a, b) in enumerate(zip(grad.placements, ctx.layout)) if a != b]
        if any(ctx.mesh.size(i) > 1 for i in moved):
            # partial sums of a bf16 gradient add up in float32, rounded once
            # (as one device's product accumulates them)
            grad = grad.to(torch.float32).redistribute(ctx.mesh, ctx.layout).to(grad.dtype)
        elif moved:  # mesh dims of one rank: nothing moves
            grad = grad.redistribute(ctx.mesh, ctx.layout)
        return grad


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """`_PinnedGrad` of a DTensor under autograd; anything else as it is."""
    return _PinnedGrad.apply(x) if is_dtensor(x) and torch.is_grad_enabled() else x


def pinned_tokens(x: torch.Tensor) -> torch.Tensor:
    """A layer's output on a mesh: in the token layout (`token_layout`),
    its gradient coming back in it (`pin_grad`); a plain tensor as it is."""
    return pin_grad(token_layout(x))


def reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """`t.reshape(*shape)`. A DTensor keeps its shards on the leading dims
    the view leaves as they are and is gathered on the others first, where
    DTensor refuses to split or merge a sharded dim (decode's query heads
    regrouped by kv head, a Mamba layer's heads that "model" does not
    divide); the gradient comes back through the same layouts."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        t = pin_grad(t)
        try:
            return pin_grad(t.reshape(*shape))
        except RuntimeError:  # "Please redistribute the tensor before this operation"
            pass
        keep = 0
        while keep < min(t.ndim, len(shape)) and t.shape[keep] == shape[keep]:
            keep += 1
        lay = [Replicate() if isinstance(pl, Shard) and pl.dim % t.ndim >= keep else pl
               for pl in t.placements]
        return pin_grad(t.redistribute(t.device_mesh, lay).reshape(*shape))
    return t.reshape(*shape)


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
def _embed_local(tokens, table):
    """`table[tokens]` for a DTensor table, on local tensors (DTensor's
    backward of the lookup is not dependable across torch versions): each
    rank looks its rows' tokens up in its vocab shard, rows of other shards
    zero, and the shards add up (an all-reduce, exact: one shard holds each
    row). The result is a DTensor laid out as the tokens, with the table's
    dtype; with the vocabulary whole on every rank it is the plain lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if is_dtensor(tokens):
        tok, tok_lay = tokens.to_local(), tokens.placements
    else:
        tok, tok_lay = tokens, (Replicate(),) * mesh.ndim
    vocab = [i for i, pl in enumerate(table.placements) if pl == Shard(0)]
    rows = [i for i, pl in enumerate(tok_lay) if pl == Shard(0)]
    t = table.to_local(grad_placements=tuple(
        Shard(0) if i in vocab else (Partial() if i in rows else Replicate())
        for i in range(mesh.ndim)))
    vocab = [i for i in vocab if mesh.size(i) > 1]
    if not vocab:
        return DTensor.from_local(t[tok], mesh, tok_lay, run_check=False)
    coord, shard = mesh.get_coordinate(), 0
    for i in vocab:
        shard = shard * mesh.size(i) + coord[i]
    idx = tok.to(torch.long) - shard * t.shape[0]
    mine = (idx >= 0) & (idx < t.shape[0])
    x = t[torch.clamp(idx, 0, t.shape[0] - 1)] * mine[..., None].to(t.dtype)
    part = tuple(Partial() if i in vocab else tok_lay[i] for i in range(mesh.ndim))
    return DTensor.from_local(x, mesh, part, run_check=False)


def embed(tokens: torch.Tensor, table: torch.Tensor, scale_by_dim: bool = False):
    x = _embed_local(tokens, table) if is_dtensor(table) else table[tokens]
    if scale_by_dim:
        # repro multiplies by np.sqrt(d), a float64 numpy scalar: float32 product
        x = x.to(torch.float32) * float(np.sqrt(table.shape[1]))
    return token_layout(x.to(DEFAULT_DTYPE))


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


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor (a tensor laid out over a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def token_layout(x: torch.Tensor) -> torch.Tensor:
    """Activations [B, ...] between layers: on a mesh, the batch over the data
    axes (where it divides) and replicated over the others, partial sums
    added up; a plain tensor as it is. Left to itself DTensor may shard the
    model width or replicate the batch (gathering every rank's rows),
    which `repro`'s layout never does."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    dp = [i for i, a in enumerate(mesh.mesh_dim_names) if a in ("pod", "data")]
    n_dp = 1
    for i in dp:
        n_dp *= mesh.size(i)
    on_b = Shard(0) if x.shape[0] % n_dp == 0 else Replicate()
    lay = tuple(on_b if i in dp else Replicate() for i in range(mesh.ndim))
    return x if tuple(x.placements) == lay else x.redistribute(mesh, lay)


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """t [..., n * d] -> [..., n, d]. A DTensor whose last dim is split over
    mesh dims that n does not divide (8 kv heads on a "model" axis of 16)
    is first gathered on those, where DTensor refuses the view."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        mesh, last, k = t.device_mesh, t.ndim - 1, 1
        lay = list(t.placements)
        for i, pl in enumerate(lay):
            if isinstance(pl, Shard) and pl.dim % t.ndim == last:
                if n % (k * mesh.size(i)) == 0:
                    k *= mesh.size(i)
                else:
                    lay[i] = Replicate()
        if lay != list(t.placements):
            t = t.redistribute(mesh, lay)
        return pin_grad(pin_grad(t).reshape(*t.shape[:-1], n, d))
    return t.reshape(*t.shape[:-1], n, d)


def _allreduce(t: torch.Tensor, mesh, dims, op: str = "sum") -> torch.Tensor:
    """t summed (or maxed) over the mesh dims `dims`, every rank's value
    used alike afterwards: DTensor's Partial -> Replicate, whose backward
    gives each rank the whole gradient (d sum / d part = 1)."""
    if not dims:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    part = tuple(Partial(op) if i in dims else Replicate() for i in range(mesh.ndim))
    return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local()


def _vocab_parallel_ce_sum(xc, table, lc, logit_cap):
    """`_chunk_ce_sum` on DTensors, vocab-parallel on local tensors (DTensor
    has no strategy for `gather` on a vocab-sharded dim, and its einsum
    backward may pick a strided layout it cannot propagate): each rank
    computes the logits of its rows against its vocab shard; the max, the
    sum of exponentials and the gold logit reduce over the vocab shards,
    an all-reduce each; the rows' sum of logz - gold is a partial sum over
    the data axes. Returns a float32 DTensor scalar."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xc.device_mesh
    rows = [i for i, pl in enumerate(xc.placements) if pl == Shard(0)]
    vocab = [i for i, pl in enumerate(table.placements) if pl == Shard(0)]
    x_grad = tuple(Partial() if i in vocab else pl for i, pl in enumerate(xc.placements))
    t_grad = tuple(Shard(0) if i in vocab else (Partial() if i in rows else Replicate())
                   for i in range(mesh.ndim))
    x = xc.to_local(grad_placements=x_grad)
    t = table.to_local(grad_placements=t_grad)
    lab = lc.redistribute(mesh, xc.placements).to_local().to(torch.long)
    logits = unembed(x, t, logit_cap)  # [b, c, V / shards] float32
    part = tuple(Partial() if i in rows else Replicate() for i in range(mesh.ndim))
    vocab = [i for i in vocab if mesh.size(i) > 1]  # a mesh dim of 1 splits nothing
    if not vocab:  # the whole vocabulary here: the single-device sum, bit for bit
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        return DTensor.from_local(torch.sum(logz - gold), mesh, part, run_check=False)
    coord, shard = mesh.get_coordinate(), 0
    for i in vocab:
        shard = shard * mesh.size(i) + coord[i]
    first = shard * t.shape[0]
    m = _allreduce(torch.amax(logits, dim=-1, keepdim=True).detach(), mesh, vocab, "max")
    logz = torch.log(_allreduce(torch.sum(torch.exp(logits - m), dim=-1), mesh, vocab)) + m[..., 0]
    local = lab - first
    mine = (local >= 0) & (local < t.shape[0])
    picked = torch.gather(logits, -1, torch.clamp(local, 0, t.shape[0] - 1)[..., None])[..., 0]
    gold = _allreduce(torch.where(mine, picked, 0.0), mesh, vocab)
    return DTensor.from_local(torch.sum(logz - gold), mesh, part, run_check=False)


def _chunk_ce_sum(xc, table, lc, logit_cap):
    if is_dtensor(xc):
        return _vocab_parallel_ce_sum(xc, table, lc, logit_cap)
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
