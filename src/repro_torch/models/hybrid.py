"""Zamba2-style hybrid in PyTorch: a Mamba-2 backbone and one SHARED
attention block applied after every `shared_every` Mamba layers (its
weights reused at every site, its KV rows apart for each). Counterpart of
`repro.models.hybrid`, with `repro`'s simplifications of the HF release:
one shared transformer block, no per-site LoRA deltas, and the
concat(hidden, embedding) input projection of the Zamba family.

The shared block's prefill attention takes `cfg.attn_impl`: "flash" is the
bf16 flash kernel on the card (its head dim 80 padded to 128 inside the
kernel) and its plain version on the CPU. Decode attends densely over the
site's cache rows, as `repro` does.

Parameters: {"embed", "final_norm", "layers": n_super lists of
shared_every Mamba layer dicts (`models.ssm`), "shared": the block's
{"w_in", "ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd",
"w_out"}}. Decode cache, flat where `repro` nests its KV under "attn":
{"ssm": float32 [n_super, shared_every, B, H, N, P], "conv": bf16
[n_super, shared_every, B, W-1, C], "k", "v": bf16 [n_super, B, T, KH,
D]}, updated in place (`repro_torch.convert.cache_from_arrays` crosses
between the two).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.decoder import TensorSpec, _write_token, allocate, check_supported


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int  # mamba layers (54)
    d_model: int
    d_state: int
    vocab: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    shared_every: int = 6
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    chunk: int = 128
    remat: str = "full"  # "none" | "dots" | "full" (common.remat), each site
    attn_impl: str = "auto"  # "auto" | "dense" | "blockwise" | "flash"
    sub_quadratic: bool = True
    tie_embed: bool = True

    @property
    def n_super(self) -> int:
        if self.n_layers % self.shared_every:
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of shared_every "
                             f"{self.shared_every}")
        return self.n_layers // self.shared_every

    @property
    def mamba(self) -> ssm_lib.Mamba2Config:
        """The backbone's Mamba config: Mamba2Config's defaults (head_dim
        64, expand 2, one group, conv width 4), as `repro`'s."""
        return ssm_lib.Mamba2Config(
            name=self.name + "-mamba",
            n_layers=self.n_layers,
            d_model=self.d_model,
            d_state=self.d_state,
            vocab=self.vocab,
            chunk=self.chunk,
        )

    def param_count(self) -> int:
        m = self.mamba.param_count() - self.vocab * self.d_model - self.d_model
        d, h, k, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        shared = (
            2 * d * d  # w_in (2d->d), w_out
            + d * d
            + d * (h + 2 * k) * hd
            + h * hd * d
            + 3 * d * self.d_ff
            + 2 * d
        )
        return int(m + shared + self.vocab * d + d)

    def active_param_count(self) -> int:
        return self.param_count()


def _init_shared(generator: torch.Generator, cfg: HybridConfig) -> Dict[str, torch.Tensor]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=generator.device)  # noqa: E731
    return {
        "w_in": cm.ninit(generator, (2 * d, d), 2 * d),
        "ln1": zeros(),
        "wq": cm.ninit(generator, (d, h * hd), d),
        "wk": cm.ninit(generator, (d, k * hd), d),
        "wv": cm.ninit(generator, (d, k * hd), d),
        "wo": cm.ninit(generator, (h * hd, d), h * hd),
        "ln2": zeros(),
        "wg": cm.ninit(generator, (d, cfg.d_ff), d),
        "wu": cm.ninit(generator, (d, cfg.d_ff), d),
        "wd": cm.ninit(generator, (cfg.d_ff, d), cfg.d_ff),
        "w_out": cm.ninit(generator, (d, d), d),
    }


def init_params(generator: torch.Generator, cfg: HybridConfig) -> Dict[str, Any]:
    """Random parameters from `generator`, on its device (the port's own
    draws: a test that compares with `repro` converts `repro`'s)."""
    check_supported(cfg)
    mcfg = cfg.mamba
    layers = [[ssm_lib.init_mamba_layer(generator, mcfg) for _ in range(cfg.shared_every)]
              for _ in range(cfg.n_super)]
    return {
        "embed": cm.ninit(generator, (cfg.vocab, cfg.d_model), cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
        "layers": layers,
        "shared": _init_shared(generator, cfg),
    }


def param_logical(cfg: HybridConfig) -> Dict[str, Any]:
    """Logical axes of `init_params`' tree: `repro`'s, each Mamba layer's
    without the stack's ("layers", None) axes."""
    return {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": [[ssm_lib.mamba_layer_logical(cfg.mamba) for _ in range(cfg.shared_every)]
                   for _ in range(cfg.n_super)],
        "shared": {
            "w_in": ("embed", "ffn"),
            "ln1": ("embed",),
            "wq": ("embed", "heads"),
            "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"),
            "wo": ("heads", "embed"),
            "ln2": ("embed",),
            "wg": ("embed", "ffn"),
            "wu": ("embed", "ffn"),
            "wd": ("ffn", "embed"),
            "w_out": ("embed", "ffn"),
        },
    }


def _shared_block(x, x0, p, cfg: HybridConfig, positions, impl, cache=None, pos=None):
    """The shared attention block at one site. x, x0 (the embeddings)
    [B, S, d]. With `cache` (the site's (k, v) rows [B, T, KH, D]) it is a
    decode step: the new rows are written in place at `pos` (a scalar or
    [B]) and the query attends densely over rows 0..pos."""
    # on a mesh the products' outputs are pinned to the token layout, their
    # gradients with them (`common.pinned_tokens`)
    h = cm.pinned_tokens(torch.cat([x, x0], dim=-1) @ p["w_in"])
    hx = cm.rms_norm(h, p["ln1"], cfg.norm_eps)
    b, s, _ = h.shape
    q = cm.split_heads(hx @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = cm.split_heads(hx @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = cm.split_heads(hx @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    if cache is not None:
        kc, vc = cache
        pos_idx = (pos if pos is not None else positions[..., 0]).to(torch.long)
        _write_token(kc, k, pos_idx)
        _write_token(vc, v, pos_idx)
        a = cm.decode_attention(q, kc, vc, valid_len=torch.broadcast_to(pos_idx + 1, (b,)))
    else:
        a = cm.attention(q, k, v, impl=impl, causal=True)
    h = h + cm.pinned_tokens(cm.reshape(a, b, s, cfg.n_heads * cfg.head_dim) @ p["wo"])
    hx = cm.rms_norm(h, p["ln2"], cfg.norm_eps)
    h = h + cm.pinned_tokens(cm.gated_mlp(hx, p["wg"], p["wu"], p["wd"]))
    return x + cm.pinned_tokens(h @ p["w_out"])


def _site(x, x0, site, shared, cfg: HybridConfig, positions, impl):
    """One site: its Mamba layers, then the shared block."""
    mcfg = cfg.mamba
    for mp in site:
        x = ssm_lib.mamba_block(x, mp, mcfg)
    return _shared_block(x, x0, shared, cfg, positions, impl)


def forward(params, tokens: torch.Tensor, cfg: HybridConfig):
    """Training and prefill trunk. tokens [B, S] -> (final features
    [B, S, d], 0). Under autograd each site (its Mamba layers and the
    shared block) runs under `cfg.remat`, as `repro`'s scanned site body
    does; the shared block's gradient adds up over its sites."""
    check_supported(cfg)
    x0 = cm.embed(tokens, params["embed"])
    x = x0
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    site_fn = cm.remat(_site, cfg.remat)
    for site in params["layers"]:
        x = cm.token_layout(site_fn(x, x0, site, params["shared"], cfg, positions,
                                    cfg.attn_impl))
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch, cfg: HybridConfig) -> torch.Tensor:
    """Mean next-token cross entropy of batch["labels"] (chunked)."""
    feats, aux = forward(params, batch["tokens"], cfg)
    return cm.cross_entropy_chunked(feats, params["embed"], batch["labels"]) + aux


@torch.no_grad()
def prefill_logits(params, batch, cfg: HybridConfig) -> torch.Tensor:
    """Next-token logits [B, 1, V] float32 of a prompt batch."""
    feats, _ = forward(params, batch["tokens"], cfg)
    return cm.last_token_logits(feats, params["embed"])


def init_cache_shape(cfg: HybridConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    m = cfg.mamba
    kv = TensorSpec((cfg.n_super, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
                    cm.DEFAULT_DTYPE)
    return {
        "ssm": TensorSpec((cfg.n_super, cfg.shared_every, batch, m.n_heads, m.d_state,
                           m.head_dim), torch.float32),
        "conv": TensorSpec((cfg.n_super, cfg.shared_every, batch, m.conv_width - 1,
                            m.conv_channels), cm.DEFAULT_DTYPE),
        "k": kv,
        "v": kv,
    }


def init_cache(cfg: HybridConfig, batch: int, cache_len: int, device) -> Dict[str, torch.Tensor]:
    return allocate(init_cache_shape(cfg, batch, cache_len), device)


def cache_logical(cfg: HybridConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {
        "ssm": ("layers", None, "batch", "ssm_heads", "ssm_state", "head_dim"),
        "conv": ("layers", None, "batch", "conv", "ssm_heads"),
        "k": kv,
        "v": kv,
    }


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: HybridConfig):
    """One-token decode. tokens [B, 1]; pos a scalar or [B] (each slot
    writes and attends its own KV rows). Returns (logits [B, 1, V]
    float32, cache), the cache updated in place."""
    check_supported(cfg)
    x0 = cm.embed(tokens, params["embed"])
    x = x0
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.long)
    positions = torch.broadcast_to(pos.reshape(-1, 1) if pos.ndim else pos, (b, 1))
    mcfg = cfg.mamba
    for i, site in enumerate(params["layers"]):
        for j, mp in enumerate(site):
            x, ssm, conv = ssm_lib.mamba_decode_block(x, mp, mcfg, cache["ssm"][i, j],
                                                      cache["conv"][i, j])
            x = cm.token_layout(x)
            cache["ssm"][i, j].copy_(ssm)
            cache["conv"][i, j].copy_(conv)
        x = cm.token_layout(_shared_block(x, x0, params["shared"], cfg, positions, "dense",
                                          cache=(cache["k"][i], cache["v"][i]), pos=pos))
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(x, params["embed"]), cache
