"""Decoder-only LM (PyTorch), dense and MoE, over a plain parameter dictionary.

Counterpart of `repro.models.decoder`: gemma-2b, gemma2-27b, internlm2-20b,
minitron-8b, deepseek-moe-16b, qwen3-moe-30b-a3b and the LM backbone of
internvl2-2b (`models.vlm`, through `embeds=`). Local/global attention
patterns, windows, attention and final soft-caps, a Python-float query
scale, post-norms, embedding scale, tied or separate unembedding,
silu/gelu (gated) or relu2 MLPs, MoE FFN layers (`models.moe`), dense
prefix layers and the int8 KV cache.

Parameters: {"embed": [V, d], "final_norm": [d], "layers": [one dict a
layer], "unembed": [V, d] when not tied}. The first `n_dense_prefix`
layers are dense prefix layers: a gated MLP of width `dense_prefix_ff` and
global attention. Each later layer i has an MoE FFN (under `"moe"`) when
the config has one, else a dense MLP of width `d_ff`, and the attention
kind of pattern position (i - n_dense_prefix) % len(attn_pattern). `repro`
stacks the prefix layers in `params["prefix"]` and the others per pattern
position; layer n_dense_prefix + g * len(attn_pattern) + p here is its
`params["layers"][p][g]` (`repro_torch.convert.decoder_params_from_arrays`
crosses between the two).

KV cache, one row of layers where `repro` keeps one stack per pattern
position (and one for the prefix): {"k": [L, B, T, KH, D], "v": ...} in
bf16, or with the int8 cache (`kv_quant` or `REPRO_KV_QUANT=1`)
{"k_q", "v_q": int8 [L, B, T, KH, D], "k_s", "v_s": float32
[L, B, T, KH, 1]}. `decode_step` writes the new token's rows into it IN
PLACE and returns the same tensors; the int8 cache quantizes only the new
token and dequantizes the whole view for attention.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import moe as moe_lib


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
    moe: Optional[moe_lib.MoEConfig] = None
    n_dense_prefix: int = 0  # deepseek: leading dense-FFN layers
    dense_prefix_ff: int = 0  # their width
    remat: str = "full"  # "none" | "dots" | "full" (common.remat), each layer
    attn_impl: str = "auto"  # "auto" | "dense" | "blockwise" | "flash"
    sub_quadratic: bool = False
    kv_quant: bool = False  # int8 KV cache (env REPRO_KV_QUANT=1 also turns it on)

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        if self.moe:
            m = self.moe
            ffn = d * m.n_experts + 3 * m.n_experts * d * m.d_expert
            ffn += 3 * d * m.d_expert * m.n_shared
        else:
            ffn = (2 if self.act == "relu2" else 3) * d * self.d_ff
        n = self.n_layers * (attn + ffn + 2 * d)
        n += self.n_dense_prefix * (3 * d * self.dense_prefix_ff - ffn)
        n += self.vocab * d * (1 if self.tie_embed else 2) + d
        return int(n)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: routed top-k and shared only). As in
        `repro`, every layer counts its routed experts out, prefix layers too."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        routed_all = 3 * m.n_experts * self.d_model * m.d_expert
        routed_act = 3 * m.top_k * self.d_model * m.d_expert
        return int(self.param_count() - self.n_layers * (routed_all - routed_act))


def _kv_quant_on(cfg: DecoderConfig) -> bool:
    return cfg.kv_quant or os.environ.get("REPRO_KV_QUANT", "0") == "1"


def check_supported(cfg: DecoderConfig) -> None:
    """Raise on an attention route the port does not have."""
    if cfg.attn_impl not in cm.ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not one of {cm.ATTN_IMPLS}")


def layer_kind(cfg: DecoderConfig, i: int) -> str:
    """Attention kind of layer i: global for a prefix layer, else the pattern
    position counted from the first layer after the prefix."""
    if i < cfg.n_dense_prefix:
        return "global"
    return cfg.attn_pattern[(i - cfg.n_dense_prefix) % len(cfg.attn_pattern)]


def ffn_kind(cfg: DecoderConfig, i: int) -> str:
    """The FFN of layer i: "dense_prefix", "moe" or "dense"."""
    if i < cfg.n_dense_prefix:
        return "dense_prefix"
    return "moe" if cfg.moe else "dense"


# ----------------------------------------------------------------- params
def _init_layer(gen: torch.Generator, cfg: DecoderConfig, kind: str) -> Dict[str, Any]:
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
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, d, cfg.moe)
        return p
    ff = cfg.dense_prefix_ff if kind == "dense_prefix" else cfg.d_ff
    p["wg"] = cm.ninit(gen, (d, ff), d)
    if cfg.act != "relu2":  # relu2 MLP is non-gated (no up-projection)
        p["wu"] = cm.ninit(gen, (d, ff), d)
    p["wd"] = cm.ninit(gen, (ff, d), ff)
    return p


def init_params(generator: torch.Generator, cfg: DecoderConfig) -> Dict[str, Any]:
    """Random parameters from `generator`, on the generator's device, drawn
    tensor by tensor. The draws are the port's own: a test that compares
    with `repro` converts `repro`'s parameters instead."""
    check_supported(cfg)
    params = {
        "embed": cm.ninit(generator, (cfg.vocab, cfg.d_model), cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
        "layers": [_init_layer(generator, cfg, ffn_kind(cfg, i))
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embed:
        params["unembed"] = cm.ninit(generator, (cfg.vocab, cfg.d_model), cfg.d_model)
    return params


def _layer_logical(cfg: DecoderConfig, kind: str) -> Dict[str, Any]:
    """Logical axes of one layer's parameters (`repro`'s less its leading
    "layers" axis: the port keeps a list of layers, not a stack)."""
    spec = {
        "ln1": ("embed",),
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
        "ln2": ("embed",),
    }
    if cfg.post_norms:
        spec["post_attn"] = ("embed",)
        spec["post_ffn"] = ("embed",)
    if kind == "moe":
        spec["moe"] = moe_lib.moe_logical(cfg.moe)
    else:
        spec["wg"] = ("embed", "ffn")
        if cfg.act != "relu2":
            spec["wu"] = ("embed", "ffn")
        spec["wd"] = ("ffn", "embed")
    return spec


def param_logical(cfg: DecoderConfig) -> Dict[str, Any]:
    """Logical axes of `init_params`' tree, leaf for leaf: layer i's are
    `repro`'s of its stack (prefix or pattern position) without the
    stack's "layers" axis, which no rule shards."""
    spec = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": [_layer_logical(cfg, ffn_kind(cfg, i)) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embed:
        spec["unembed"] = ("vocab", "embed")
    return spec


def unembed_table(params, cfg: DecoderConfig):
    return params["embed"] if cfg.tie_embed else params["unembed"]


# ----------------------------------------------------------------- forward
def _write_token(entry: torch.Tensor, new: torch.Tensor, pos_idx: torch.Tensor) -> None:
    """Write one decode token [B, 1, ...] into a cache array [B, T, ...] in
    place at `pos_idx`: a scalar (all rows at one position) or a [B] vector
    (each row writes its own lane at its own position)."""
    if cm.is_dtensor(entry):
        return _write_token_sharded(entry, new, pos_idx)
    new = new.to(entry.dtype)
    if pos_idx.ndim == 1:
        entry[torch.arange(entry.shape[0], device=entry.device), pos_idx] = new[:, 0]
    else:
        entry[:, pos_idx] = new[:, 0]


def _write_token_sharded(entry, new, pos_idx) -> None:
    """`_write_token` into a DTensor cache entry [B, T, ...], which DTensor
    cannot index in place: each rank writes its own rows. The new token is
    laid out as the entry but for the sequence, which it has whole; the rank
    whose sequence shard holds the position writes it, the others write
    their rows back as they were (no host read of the position)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = entry.device_mesh
    seq_dims = [i for i, pl in enumerate(entry.placements) if pl == Shard(1)]
    layout = tuple(Replicate() if i in seq_dims else pl for i, pl in enumerate(entry.placements))
    loc = entry.to_local()
    new_loc = new.redistribute(mesh, layout).to_local().to(loc.dtype)
    t_loc = loc.shape[1]
    coord, shard = mesh.get_coordinate(), 0
    for i in seq_dims:
        shard = shard * mesh.size(i) + coord[i]
    if cm.is_dtensor(pos_idx):
        pos_idx = pos_idx.full_tensor()
    pos_idx = pos_idx.to(device=loc.device, dtype=torch.long)
    rows = torch.arange(loc.shape[0], device=loc.device)
    if pos_idx.ndim == 1:  # a position a row: this rank's rows of the batch
        batch_dims = [i for i, pl in enumerate(entry.placements) if pl == Shard(0)]
        first = 0
        for i in batch_dims:
            first = first * mesh.size(i) + coord[i]
        pos_idx = pos_idx[first * loc.shape[0]:(first + 1) * loc.shape[0]]
    rel = pos_idx - shard * t_loc
    mine = (rel >= 0) & (rel < t_loc)
    rel = torch.clamp(rel, 0, t_loc - 1)
    if pos_idx.ndim == 1:
        old = loc[rows, rel]
        keep = mine.reshape((-1,) + (1,) * (loc.ndim - 2))
        loc[rows, rel] = torch.where(keep, new_loc[:, 0], old)
    else:  # index_select / index_copy_: a 0-d index would be read on the host
        at = rel.reshape(1)
        loc.index_copy_(1, at, torch.where(mine, new_loc, loc.index_select(1, at)))


def _cache_write_read(entry, new: torch.Tensor, pos_idx: torch.Tensor) -> torch.Tensor:
    """Write one token into a cache entry (a bf16 view, or an int8 view and
    its scales) and return the view attention reads (dequantized to bf16)."""
    if isinstance(entry, tuple):
        q, s = cm.kv_quantize(new)
        _write_token(entry[0], q, pos_idx)
        _write_token(entry[1], s, pos_idx)
        return cm.kv_dequantize(*entry)
    _write_token(entry, new, pos_idx)
    return entry


def _attn(x, p, cfg: DecoderConfig, kind: str, positions, impl, cache=None, pos=None):
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hx = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = cm.split_heads(hx @ p["wq"], h, hd)
    k = cm.split_heads(hx @ p["wk"], kh, hd)
    v = cm.split_heads(hx @ p["wv"], kh, hd)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else None
    if cache is not None:
        kc, vc = cache  # this layer's rows, written in place
        pos_idx = (pos if pos is not None else positions[..., 0]).to(torch.long)
        k_view = _cache_write_read(kc, k, pos_idx)
        v_view = _cache_write_read(vc, v, pos_idx)
        out = cm.decode_attention(
            q, k_view, v_view,
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
    out = cm.pinned_tokens(cm.reshape(out, b, s, h * hd) @ p["wo"])
    if cfg.post_norms:
        out = cm.rms_norm(out, p["post_attn"], cfg.norm_eps)
    return out


def _ffn(x, p, cfg: DecoderConfig, kind: str):
    """(y, aux): the layer's FFN by its kind, and the MoE aux loss (0 else)."""
    hx = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        y, aux = moe_lib.moe_ffn(hx, p["moe"], cfg.moe, cfg.act)
    elif cfg.act == "relu2":
        a = torch.square(F.relu((hx @ p["wg"]).to(torch.float32))).to(hx.dtype)
        y = cm.pinned_tokens(a @ p["wd"])
    else:
        y = cm.pinned_tokens(cm.gated_mlp(hx, p["wg"], p["wu"], p["wd"], cfg.act))
    if cfg.post_norms:
        y = cm.rms_norm(y, p["post_ffn"], cfg.norm_eps)
    return y, aux


def _block(x, p, cfg, i, positions, impl, cache=None, pos=None):
    """Layer i: (x after it, its aux loss)."""
    x = cm.token_layout(x + _attn(x, p, cfg, layer_kind(cfg, i), positions, impl, cache, pos))
    f, aux = _ffn(x, p, cfg, ffn_kind(cfg, i))
    return cm.token_layout(x + f), aux


def forward(params, tokens: Optional[torch.Tensor], cfg: DecoderConfig, *, embeds=None):
    """Training and prefill trunk. tokens [B, S], or `embeds` [B, S, d] in
    their place (cast to bf16, with no embedding scale; positions 0..S-1
    over the whole row) -> (final features [B, S, d], MoE aux loss summed
    over the layers). Under autograd each layer runs under `cfg.remat`."""
    check_supported(cfg)
    x = (cm.embed(tokens, params["embed"], cfg.embed_scale) if embeds is None
         else cm.token_layout(embeds.to(cm.DEFAULT_DTYPE)))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = cm.remat(_block, cfg.remat)
    for i, lp in enumerate(params["layers"]):
        x, a = block(x, lp, cfg, i, positions, cfg.attn_impl)
        aux = aux + a
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def loss_fn(params, batch, cfg: DecoderConfig, *, embeds=None):
    """The training objective: the mean next-token cross entropy of
    batch["labels"] (chunked, `common.cross_entropy_chunked`) plus the MoE
    aux loss of every MoE layer."""
    feats, aux = forward(params, batch.get("tokens"), cfg, embeds=embeds)
    return cm.cross_entropy_chunked(feats, unembed_table(params, cfg), batch["labels"],
                                    cfg.final_softcap) + aux


@torch.no_grad()
def prefill_logits(params, batch, cfg: DecoderConfig, *, embeds=None):
    """Next-token logits [B, 1, V] float32 of a prompt batch (or of
    `embeds`, see `forward`)."""
    feats, _ = forward(params, batch.get("tokens"), cfg, embeds=embeds)
    return cm.last_token_logits(feats, unembed_table(params, cfg), cfg.final_softcap)


# ------------------------------------------------------------------- decode
class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to allocate (`jax.ShapeDtypeStruct`'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache_shape(cfg: DecoderConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of the KV cache: bf16 k and v, or with the int8
    cache their int8 values and float32 scales a (token, head)."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    if _kv_quant_on(cfg):
        q = TensorSpec(shape, torch.int8)
        s = TensorSpec(shape[:-1] + (1,), torch.float32)
        return {"k_q": q, "k_s": s, "v_q": q, "v_s": s}
    spec = TensorSpec(shape, cm.DEFAULT_DTYPE)
    return {"k": spec, "v": spec}


def allocate(specs: Dict[str, TensorSpec], device) -> Dict[str, torch.Tensor]:
    """Zero tensors of the given shapes and dtypes on `device`."""
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device) for name, s in specs.items()}


def init_cache(cfg: DecoderConfig, batch: int, cache_len: int, device) -> Dict[str, torch.Tensor]:
    return allocate(init_cache_shape(cfg, batch, cache_len), device)


def cache_logical(cfg: DecoderConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    if _kv_quant_on(cfg):
        s = ("layers", "batch", "seq", "kv_heads", None)
        return {"k_q": kv, "k_s": s, "v_q": kv, "v_s": s}
    return {"k": kv, "v": kv}


def _layer_cache(cache, i: int):
    """Layer i's (k, v) entries: bf16 views, or (int8 view, scales) pairs."""
    if "k" in cache:
        return cache["k"][i], cache["v"][i]
    return (cache["k_q"][i], cache["k_s"][i]), (cache["v_q"][i], cache["v_s"][i])


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
        x, _ = _block(x, lp, cfg, i, positions, "dense", cache=_layer_cache(cache, i),
                      pos=pos)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(x, unembed_table(params, cfg), cfg.final_softcap)
    return logits, cache
