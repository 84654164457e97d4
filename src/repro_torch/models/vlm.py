"""InternVL2-style VLM in PyTorch: the ViT front end stubbed (precomputed
patch embeddings come with the batch), a 2-layer MLP projector, and an
InternLM2-family decoder backbone (`models.decoder`). Counterpart of
`repro.models.vlm`.

Prefill puts the projected image rows first and the text embeddings after
them, and runs the decoder over the whole row with `embeds=`. Decode is the
text decoder's own step, as in `repro`: the served cache holds text rows
only.

Parameters: {"projector": {"w1": [vit_dim, d], "w2": [d, d]} bf16, "lm":
the decoder's parameters}.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import decoder as dec_lib


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    name: str
    lm: dec_lib.DecoderConfig
    vit_dim: int = 1024
    n_patches: int = 256
    sub_quadratic: bool = False

    def param_count(self) -> int:
        proj = self.vit_dim * self.lm.d_model + self.lm.d_model * self.lm.d_model
        return int(self.lm.param_count() + proj)

    def active_param_count(self) -> int:
        return self.param_count()


def init_params(generator: torch.Generator, cfg: VLMConfig) -> Dict[str, Any]:
    """Random parameters from `generator`, on its device (the port's own
    draws: a test that compares with `repro` converts `repro`'s)."""
    d = cfg.lm.d_model
    return {
        "projector": {
            "w1": cm.ninit(generator, (cfg.vit_dim, d), cfg.vit_dim),
            "w2": cm.ninit(generator, (d, d), d),
        },
        "lm": dec_lib.init_params(generator, cfg.lm),
    }


def param_logical(cfg: VLMConfig) -> Dict[str, Any]:
    return {"projector": {"w1": ("embed", "ffn"), "w2": ("ffn", "embed")},
            "lm": dec_lib.param_logical(cfg.lm)}


def _project(patches: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Patch embeddings [B, P, vit_dim] -> [B, P, d]: the tanh GELU of the
    first product in float32, rounded to bf16 before the second."""
    h = F.gelu((patches.to(cm.DEFAULT_DTYPE) @ p["w1"]).to(torch.float32),
               approximate="tanh").to(cm.DEFAULT_DTYPE)
    return h @ p["w2"]


def _project_sharded(patches, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """`_project` of DTensors on local tensors (DTensor's own choice of
    layout for the second product's gradient is a strided one it cannot
    propagate): each rank runs its rows of the batch through its columns of
    w1 and its rows of w2 ("model" splits the projector's width), and the
    partial sums add up into the token layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = cm.token_layout(patches)
    mesh = x.device_mesh
    width = [i for i, pl in enumerate(p["w1"].placements) if pl == Shard(1)]
    if [i for i, pl in enumerate(p["w2"].placements) if pl == Shard(0)] != width:
        return cm.token_layout(_project(x, p))
    rows = [i for i, pl in enumerate(x.placements) if pl == Shard(0)]
    grad = lambda dim: tuple(Shard(dim) if i in width else  # noqa: E731
                             (Partial() if i in rows else Replicate())
                             for i in range(mesh.ndim))
    y = _project(x.to_local(), {"w1": p["w1"].to_local(grad_placements=grad(1)),
                                "w2": p["w2"].to_local(grad_placements=grad(0))})
    part = tuple(Partial() if i in width else x.placements[i] for i in range(mesh.ndim))
    return cm.token_layout(DTensor.from_local(y, mesh, part, run_check=False))


def _embeds(params, batch, cfg: VLMConfig) -> torch.Tensor:
    """The decoder's input rows: the projected image rows, then the text."""
    if cm.is_dtensor(batch["patch_embeds"]):
        img = _project_sharded(batch["patch_embeds"], params["projector"])
    else:
        img = _project(batch["patch_embeds"], params["projector"])  # [B, P, d]
    txt = cm.embed(batch["tokens"], params["lm"]["embed"])
    return torch.cat([img, txt], dim=1)


def forward(params, batch, cfg: VLMConfig):
    """batch: patch_embeds [B, P, vit_dim], tokens [B, S-P] -> (features
    [B, S, d], aux) of the decoder over the image rows and the text."""
    return dec_lib.forward(params["lm"], None, cfg.lm, embeds=_embeds(params, batch, cfg))


def loss_fn(params, batch, cfg: VLMConfig) -> torch.Tensor:
    """The decoder's loss over the whole row: batch["labels"] [B, S] covers
    the P patch rows and the S-P text tokens, as `make_inputs` lays them
    out."""
    return dec_lib.loss_fn(params["lm"], batch, cfg.lm, embeds=_embeds(params, batch, cfg))


@torch.no_grad()
def prefill_logits(params, batch, cfg: VLMConfig) -> torch.Tensor:
    """batch: patch_embeds [B, P, vit_dim], tokens [B, S-P] -> next-token
    logits [B, 1, V] float32."""
    return dec_lib.prefill_logits(params["lm"], batch, cfg.lm,
                                  embeds=_embeds(params, batch, cfg))


def init_cache_shape(cfg: VLMConfig, batch: int, cache_len: int):
    return dec_lib.init_cache_shape(cfg.lm, batch, cache_len)


def init_cache(cfg: VLMConfig, batch: int, cache_len: int, device):
    return dec_lib.init_cache(cfg.lm, batch, cache_len, device)


def cache_logical(cfg: VLMConfig):
    return dec_lib.cache_logical(cfg.lm)


def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: VLMConfig):
    """Text decode: the decoder's step over its own cache."""
    return dec_lib.decode_step(params["lm"], cache, tokens, pos, cfg.lm)
