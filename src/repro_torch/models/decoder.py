"""Dense decoder-only LM (PyTorch), over a plain parameter dictionary.

Counterpart of `repro.models.decoder` for the dense configurations
(gemma-2b, gemma2-27b, internlm2-20b, minitron-8b): local/global attention
patterns, windows, attention and final soft-caps, a Python-float query
scale, post-norms, embedding scale, tied or separate unembedding, and
silu/gelu (gated) or relu2 MLPs. MoE, dense prefixes and the int8 KV cache
raise `NotImplementedError` until their slice.

Parameters: {"embed": [V, d], "final_norm": [d], "layers": [one dict a
layer], "unembed": [V, d] when not tied}. `repro` stacks its layers per
attention-pattern position; layer i here is `repro`'s
`params["layers"][i % len(attn_pattern)][i // len(attn_pattern)]`
(`repro_torch.convert.decoder_params_from_arrays` crosses between the two).

KV cache: {"k": [L, B, T, KH, D], "v": [L, B, T, KH, D]} in bf16, one row
of layers where `repro` keeps one stack per pattern position. `decode_step`
writes the new token's rows into it IN PLACE and returns the same tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # "silu" | "gelu" (gated) | "relu2" (non-gated)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    attn_pattern: Tuple[str, ...] = ("global",)  # cycled over layers
    window: int = 4096  # local-attention window
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # None -> 1/sqrt(head_dim)
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    tie_embed: bool = True
    post_norms: bool = False  # gemma2: post-attn/post-ffn RMSNorms
    moe: Optional[Any] = None  # not ported yet
    n_dense_prefix: int = 0  # not ported yet
    dense_prefix_ff: int = 0
    remat: str = "full"  # kept for parity with repro; the port has no backward yet
    attn_impl: str = "auto"  # "auto" | "dense" | "blockwise" | "flash"
    sub_quadratic: bool = False
    kv_quant: bool = False  # int8 KV cache: not ported yet

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        if self.moe:
            raise NotImplementedError("MoE decoders are not ported yet")
        ffn = (2 if self.act == "relu2" else 3) * d * self.d_ff
        n = self.n_layers * (attn + ffn + 2 * d)
        n += self.n_dense_prefix * (3 * d * self.dense_prefix_ff - ffn)
        n += self.vocab * d * (1 if self.tie_embed else 2) + d
        return int(n)


def _kv_quant_on(cfg: DecoderConfig) -> bool:
    return cfg.kv_quant or os.environ.get("REPRO_KV_QUANT", "0") == "1"


def check_supported(cfg: DecoderConfig) -> None:
    """Raise NotImplementedError on what this slice does not port."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet")
    if cfg.n_dense_prefix:
        raise NotImplementedError(f"{cfg.name}: dense prefix layers are not ported yet")
    if _kv_quant_on(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the int8 KV cache (kv_quant / REPRO_KV_QUANT=1) is not ported yet")
    if cfg.attn_impl not in cm.ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not one of {cm.ATTN_IMPLS}")


def layer_kind(cfg: DecoderConfig, i: int) -> str:
    return cfg.attn_pattern[i % len(cfg.attn_pattern)]


# ----------------------------------------------------------------- params
def _init_layer(gen: torch.Generator, cfg: DecoderConfig) -> Dict[str, torch.Tensor]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=dev)  # noqa: E731
    p = {
        "ln1": zeros(),
        "wq": cm.ninit(gen, (d, h * hd), d),
        "wk": cm.ninit(gen, (d, k * hd), d),
        "wv": cm.ninit(gen, (d, k * hd), d),
        "wo": cm.ninit(gen, (h * hd, d), h * hd),
        "ln2": zeros(),
    }
    if cfg.post_norms:
        p["post_attn"] = zeros()
        p["post_ffn"] = zeros()
    p["wg"] = cm.ninit(gen, (d, cfg.d_ff), d)
    if cfg.act != "relu2":  # relu2 MLP is non-gated (no up-projection)
        p["wu"] = cm.ninit(gen, (d, cfg.d_ff), d)
    p["wd"] = cm.ninit(gen, (cfg.d_ff, d), cfg.d_ff)
    return p


def init_params(generator: torch.Generator, cfg: DecoderConfig) -> Dict[str, Any]:
    """Random parameters from `generator`, on the generator's device. The
    draws are the port's own: a test that compares with `repro` converts
    `repro`'s parameters instead."""
    check_supported(cfg)
    params = {
        "embed": cm.ninit(generator, (cfg.vocab, cfg.d_model), cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
        "layers": [_init_layer(generator, cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embed:
        params["unembed"] = cm.ninit(generator, (cfg.vocab, cfg.d_model), cfg.d_model)
    return params


def unembed_table(params, cfg: DecoderConfig):
    return params["embed"] if cfg.tie_embed else params["unembed"]


# ----------------------------------------------------------------- forward
def _write_token(entry: torch.Tensor, new: torch.Tensor, pos_idx: torch.Tensor) -> None:
    """Write one decode token [B, 1, ...] into a cache array [B, T, ...] in
    place at `pos_idx`: a scalar (all rows at one position) or a [B] vector
    (each row writes its own lane at its own position)."""
    new = new.to(entry.dtype)
    if pos_idx.ndim == 1:
        entry[torch.arange(entry.shape[0], device=entry.device), pos_idx] = new[:, 0]
    else:
        entry[:, pos_idx] = new[:, 0]


def _attn(x, p, cfg: DecoderConfig, kind: str, positions, impl, cache=None, pos=None):
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hx = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (hx @ p["wq"]).reshape(b, s, h, hd)
    k = (hx @ p["wk"]).reshape(b, s, kh, hd)
    v = (hx @ p["wv"]).reshape(b, s, kh, hd)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else None
    if cache is not None:
        kc, vc = cache  # [B, T, KH, D] views of this layer's rows, written in place
        pos_idx = (pos if pos is not None else positions[..., 0]).to(torch.long)
        _write_token(kc, k, pos_idx)
        _write_token(vc, v, pos_idx)
        out = cm.decode_attention(
            q, kc, vc,
            valid_len=torch.broadcast_to(pos_idx + 1, (b,)),
            window=window,
            attn_softcap=cfg.attn_softcap,
            scale=cfg.query_scale,
        )
    else:
        out = cm.attention(
            q, k, v,
            impl=impl,
            causal=True,
            window=window,
            attn_softcap=cfg.attn_softcap,
            scale=cfg.query_scale,
        )
    out = out.reshape(b, s, h * hd) @ p["wo"]
    if cfg.post_norms:
        out = cm.rms_norm(out, p["post_attn"], cfg.norm_eps)
    return out


def _ffn(x, p, cfg: DecoderConfig):
    hx = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.act == "relu2":
        a = torch.square(F.relu((hx @ p["wg"]).to(torch.float32))).to(hx.dtype)
        y = a @ p["wd"]
    else:
        y = cm.gated_mlp(hx, p["wg"], p["wu"], p["wd"], cfg.act)
    if cfg.post_norms:
        y = cm.rms_norm(y, p["post_ffn"], cfg.norm_eps)
    return y


def _block(x, p, cfg, kind, positions, impl, cache=None, pos=None):
    x = x + _attn(x, p, cfg, kind, positions, impl, cache, pos)
    return x + _ffn(x, p, cfg)


@torch.no_grad()
def forward(params, tokens: torch.Tensor, cfg: DecoderConfig):
    """Prefill trunk. tokens [B, S] -> final features [B, S, d] (`repro`
    also returns the MoE aux loss, always 0 here)."""
    check_supported(cfg)
    x = cm.embed(tokens, params["embed"], cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, lp in enumerate(params["layers"]):
        x = _block(x, lp, cfg, layer_kind(cfg, i), positions, cfg.attn_impl)
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps)


def prefill_logits(params, batch, cfg: DecoderConfig):
    """Next-token logits [B, 1, V] float32 of a prompt batch."""
    feats = forward(params, batch["tokens"], cfg)
    return cm.last_token_logits(feats, unembed_table(params, cfg), cfg.final_softcap)


# ------------------------------------------------------------------- decode
class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to allocate (`jax.ShapeDtypeStruct`'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache_shape(cfg: DecoderConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    check_supported(cfg)
    spec = TensorSpec((cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
                      cm.DEFAULT_DTYPE)
    return {"k": spec, "v": spec}


def init_cache(cfg: DecoderConfig, batch: int, cache_len: int, device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in init_cache_shape(cfg, batch, cache_len).items()}


def cache_logical(cfg: DecoderConfig) -> Dict[str, Tuple[str, ...]]:
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv}


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: DecoderConfig):
    """One-token decode. tokens [B, 1]; pos a scalar (lockstep write
    position) or [B] (per-slot positions: each slot writes and attends its
    own cache prefix). Returns (logits [B, 1, V] float32, cache), the cache
    updated in place."""
    check_supported(cfg)
    x = cm.embed(tokens, params["embed"], cfg.embed_scale)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.long)
    positions = torch.broadcast_to(pos.reshape(-1, 1) if pos.ndim else pos, (b, 1))
    for i, lp in enumerate(params["layers"]):
        x = _block(x, lp, cfg, layer_kind(cfg, i), positions, "dense",
                   cache=(cache["k"][i], cache["v"][i]), pos=pos)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, unembed_table(params, cfg), cfg.final_softcap)
    return logits, cache
