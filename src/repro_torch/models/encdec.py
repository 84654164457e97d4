"""Whisper-style encoder-decoder backbone in PyTorch (counterpart of
`repro.models.encdec`).

The audio frontend is stubbed as in `repro`: the inputs are frame
embeddings at d_model, and a learned [d, d] matrix stands in for the conv
stack. LayerNorm with bias, the tanh-GELU MLP, sinusoidal encoder
positions, learned decoder positions, and multi-head attention with as many
kv heads as heads.

Attention takes `cfg.attn_impl` in the encoder and in the decoder's prefill:
with "flash" the encoder's self-attention and the decoder's cross-attention
(its keys the encoder's frames: Skv != Sq) run the bf16 flash kernel
non-causal, and the decoder's self-attention runs it causal. Decode attends
densely over its caches, as `repro` does.

Parameters: {"frontend": [d, d], "enc_layers": [one dict a layer],
"enc_norm": {"scale", "bias"}, "embed": [V, d], "dec_pos": [max_dec_len,
d], "dec_layers": [one dict a layer], "dec_norm"}. An encoder layer is
{"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2", "w1", "b1", "w2", "b2"}, a
decoder layer also {"ln_cross", "cross"}; the norms' scale and bias and the
MLP biases are float32, all else bf16. `repro` stacks the layers
(`repro_torch.convert` crosses between the two).

Decode cache, flat where `repro` nests it: {"self_k", "self_v", "cross_k",
"cross_v"}, each bf16 [L, B, T, KH, D]. `decode_step` writes the token's
self rows in place; it reads all T rows of the cross cache, which neither
`repro` nor the port fills: the caller projects the encoder's output into
it through each layer's cross `wk` / `wv`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.models.decoder import TensorSpec, _write_token, allocate, check_supported


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    max_dec_len: int = 32_768
    dec_ratio: int = 8  # train/prefill: dec_len = enc_len // dec_ratio
    norm_eps: float = 1e-5
    remat: str = "full"  # "none" | "dots" | "full" (common.remat), each layer
    attn_impl: str = "auto"  # "auto" | "dense" | "blockwise" | "flash"
    sub_quadratic: bool = False

    def param_count(self) -> int:
        d, h, hd, ff = self.d_model, self.n_heads, self.head_dim, self.d_ff
        attn = d * (h + 2 * self.n_kv_heads) * hd + h * hd * d
        mlp = 2 * d * ff + ff + d
        enc = self.n_enc_layers * (attn + mlp + 4 * d)
        dec = self.n_dec_layers * (2 * attn + mlp + 6 * d)
        return int(enc + dec + self.vocab * d + self.max_dec_len * d + d * d + 4 * d)

    def active_param_count(self) -> int:
        return self.param_count()


# ------------------------------------------------------------------ params
def _ln(d: int, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def _init_attn(gen: torch.Generator, cfg: EncDecConfig) -> Dict[str, torch.Tensor]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": cm.ninit(gen, (d, h * hd), d), "wk": cm.ninit(gen, (d, k * hd), d),
            "wv": cm.ninit(gen, (d, k * hd), d), "wo": cm.ninit(gen, (h * hd, d), h * hd)}


def _init_enc_layer(gen: torch.Generator, cfg: EncDecConfig) -> Dict[str, Any]:
    d, dev = cfg.d_model, gen.device
    return {"ln1": _ln(d, dev), "attn": _init_attn(gen, cfg), "ln2": _ln(d, dev),
            "w1": cm.ninit(gen, (d, cfg.d_ff), d),
            "b1": torch.zeros((cfg.d_ff,), dtype=torch.float32, device=dev),
            "w2": cm.ninit(gen, (cfg.d_ff, d), cfg.d_ff),
            "b2": torch.zeros((d,), dtype=torch.float32, device=dev)}


def _init_dec_layer(gen: torch.Generator, cfg: EncDecConfig) -> Dict[str, Any]:
    p = _init_enc_layer(gen, cfg)
    p["ln_cross"] = _ln(cfg.d_model, gen.device)
    p["cross"] = _init_attn(gen, cfg)
    return p


def init_params(generator: torch.Generator, cfg: EncDecConfig) -> Dict[str, Any]:
    """Random parameters from `generator`, on its device (the port's own
    draws: a test that compares with `repro` converts `repro`'s)."""
    check_supported(cfg)
    d, dev = cfg.d_model, generator.device
    return {
        "frontend": cm.ninit(generator, (d, d), d),
        "enc_layers": [_init_enc_layer(generator, cfg) for _ in range(cfg.n_enc_layers)],
        "enc_norm": _ln(d, dev),
        "embed": cm.ninit(generator, (cfg.vocab, d), d),
        "dec_pos": cm.ninit(generator, (cfg.max_dec_len, d), d),
        "dec_layers": [_init_dec_layer(generator, cfg) for _ in range(cfg.n_dec_layers)],
        "dec_norm": _ln(d, dev),
    }


_ATTN_SPEC = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
              "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
_LN_SPEC = {"scale": ("embed",), "bias": ("embed",)}


def _enc_layer_logical() -> Dict[str, Any]:
    return {"ln1": dict(_LN_SPEC), "attn": dict(_ATTN_SPEC), "ln2": dict(_LN_SPEC),
            "w1": ("embed", "ffn"), "b1": ("ffn",), "w2": ("ffn", "embed"), "b2": ("embed",)}


def _dec_layer_logical() -> Dict[str, Any]:
    s = _enc_layer_logical()
    s["ln_cross"] = dict(_LN_SPEC)
    s["cross"] = dict(_ATTN_SPEC)
    return s


def param_logical(cfg: EncDecConfig) -> Dict[str, Any]:
    """Logical axes of `init_params`' tree: `repro`'s, each layer's without
    the stack's "layers" axis."""
    return {
        "frontend": ("embed", "ffn"),
        "enc_layers": [_enc_layer_logical() for _ in range(cfg.n_enc_layers)],
        "enc_norm": dict(_LN_SPEC),
        "embed": ("vocab", "embed"),
        "dec_pos": ("seq", "embed"),
        "dec_layers": [_dec_layer_logical() for _ in range(cfg.n_dec_layers)],
        "dec_norm": dict(_LN_SPEC),
    }


# ----------------------------------------------------------------- layers
def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """Encoder positions [s, d] bf16: sin then cos of pos / 10000^(2i/d),
    computed in float64 numpy and cast once, as `repro` builds them."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=cm.DEFAULT_DTYPE)


def _norm(x, p, cfg: EncDecConfig):
    return cm.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _mha(hx, p, cfg: EncDecConfig, *, kv_input=None, causal: bool, impl: str,
         cache=None, pos=None):
    """Attention of hx [B, S, d] over itself, or over `kv_input` (the
    encoder's output: cross-attention). With `cache` it is a decode step:
    self-attention writes the token's (k, v) rows at `pos` in place and
    attends over rows 0..pos; cross-attention attends over all of the
    cache's rows."""
    b, s, _ = hx.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_src = hx if kv_input is None else kv_input
    q = cm.split_heads(hx @ p["wq"], h, hd)
    if cache is not None and kv_input is None:  # self-attention decode
        kc, vc = cache
        k = cm.split_heads(kv_src @ p["wk"], kh, hd)
        v = cm.split_heads(kv_src @ p["wv"], kh, hd)
        _write_token(kc, k, pos)
        _write_token(vc, v, pos)
        out = cm.decode_attention(q, kc, vc, valid_len=torch.broadcast_to(pos + 1, (b,)))
    elif cache is not None:  # cross-attention decode: the cache holds the encoder's K, V
        kc, vc = cache
        out = cm.decode_attention(q, kc, vc)
    else:
        k = cm.split_heads(kv_src @ p["wk"], kh, hd)
        v = cm.split_heads(kv_src @ p["wv"], kh, hd)
        out = cm.attention(q, k, v, impl=impl, causal=causal)
    return cm.reshape(out, b, s, h * hd) @ p["wo"]


def _enc_layer(x, lp, cfg: EncDecConfig):
    a = _mha(_norm(x, lp["ln1"], cfg), lp["attn"], cfg, causal=False, impl=cfg.attn_impl)
    x = x + a
    hx = _norm(x, lp["ln2"], cfg)
    return x + cm.vanilla_mlp(hx, lp["w1"], lp["b1"], lp["w2"], lp["b2"])


def _dec_layer(x, enc_out, lp, cfg: EncDecConfig):
    x = x + _mha(_norm(x, lp["ln1"], cfg), lp["attn"], cfg, causal=True, impl=cfg.attn_impl)
    x = x + _mha(_norm(x, lp["ln_cross"], cfg), lp["cross"], cfg, kv_input=enc_out,
                 causal=False, impl=cfg.attn_impl)
    hx = _norm(x, lp["ln2"], cfg)
    return x + cm.vanilla_mlp(hx, lp["w1"], lp["b1"], lp["w2"], lp["b2"])


# ----------------------------------------------------------------- forward
def encode(params, frames: torch.Tensor, cfg: EncDecConfig) -> torch.Tensor:
    """frames [B, S_enc, d] (the stubbed frontend's input) -> the encoder's
    output [B, S_enc, d] bf16. Under autograd each layer runs under
    `cfg.remat`."""
    check_supported(cfg)
    x = frames.to(cm.DEFAULT_DTYPE) @ params["frontend"]
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None]
    layer = cm.remat(_enc_layer, cfg.remat)
    x = cm.token_layout(x)
    for lp in params["enc_layers"]:
        x = cm.token_layout(layer(x, lp, cfg))
    return _norm(x, params["enc_norm"], cfg)


def decode_train(params, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: EncDecConfig) -> torch.Tensor:
    """The decoder over a whole token row (teacher forcing): tokens [B, S]
    against enc_out -> features [B, S, d]."""
    x = cm.embed(tokens, params["embed"]) + params["dec_pos"][None, :tokens.shape[1]].to(
        cm.DEFAULT_DTYPE)
    layer = cm.remat(_dec_layer, cfg.remat)
    for lp in params["dec_layers"]:
        x = cm.token_layout(layer(x, enc_out, lp, cfg))
    return _norm(x, params["dec_norm"], cfg)


def forward(params, batch, cfg: EncDecConfig):
    """batch {"frames" [B, S_enc, d], "tokens" [B, S_dec]} -> (decoder
    features [B, S_dec, d], aux 0)."""
    enc_out = encode(params, batch["frames"], cfg)
    feats = decode_train(params, enc_out, batch["tokens"], cfg)
    return feats, torch.zeros((), dtype=torch.float32, device=feats.device)


def loss_fn(params, batch, cfg: EncDecConfig) -> torch.Tensor:
    """Mean next-token cross entropy of batch["labels"] [B, S_dec] (chunked)."""
    feats, aux = forward(params, batch, cfg)
    return cm.cross_entropy_chunked(feats, params["embed"], batch["labels"]) + aux


@torch.no_grad()
def prefill_logits(params, batch, cfg: EncDecConfig) -> torch.Tensor:
    """Next-token logits [B, 1, V] float32 after the decoder tokens."""
    feats, _ = forward(params, batch, cfg)
    return cm.last_token_logits(feats, params["embed"])


# ------------------------------------------------------------------- decode
_CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


def init_cache_shape(cfg: EncDecConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    """Self and cross caches of `cache_len` rows each, as `repro` sizes them."""
    kv = TensorSpec((cfg.n_dec_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
                    cm.DEFAULT_DTYPE)
    return {k: kv for k in _CACHE_KEYS}


def init_cache(cfg: EncDecConfig, batch: int, cache_len: int, device) -> Dict[str, torch.Tensor]:
    return allocate(init_cache_shape(cfg, batch, cache_len), device)


def cache_logical(cfg: EncDecConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {k: kv for k in _CACHE_KEYS}


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: EncDecConfig):
    """One decoder token. tokens [B, 1]; pos the write position (a scalar:
    every row at one position, as `repro` takes it). Returns (logits
    [B, 1, V] float32, cache), the self rows written in place."""
    check_supported(cfg)
    x = cm.embed(tokens, params["embed"])
    pos = torch.as_tensor(pos, device=x.device).to(torch.long)
    x = x + params["dec_pos"][pos.reshape(1)][None].to(cm.DEFAULT_DTYPE)
    for i, lp in enumerate(params["dec_layers"]):
        hx = _norm(x, lp["ln1"], cfg)
        x = x + _mha(hx, lp["attn"], cfg, causal=True, impl="dense",
                     cache=(cache["self_k"][i], cache["self_v"][i]), pos=pos)
        hx = _norm(x, lp["ln_cross"], cfg)
        x = x + _mha(hx, lp["cross"], cfg, kv_input=x, causal=False, impl="dense",
                     cache=(cache["cross_k"][i], cache["cross_v"][i]))
        hx = _norm(x, lp["ln2"], cfg)
        x = cm.token_layout(x + cm.vanilla_mlp(hx, lp["w1"], lp["b1"], lp["w2"], lp["b2"]))
    x = _norm(x, params["dec_norm"], cfg)
    return cm.unembed(x, params["embed"]), cache

