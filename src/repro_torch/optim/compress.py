"""int8 gradient compression with error feedback (port of
`repro.optim.compress`).

Each gradient tensor is quantized to int8 with one symmetric scale, and the
float32 residual is carried into the next step's gradient (error feedback),
so that the compression bias does not build up over steps. Trees are the
port's (`optim.adamw.tree_map`: dicts, lists and tuples of tensors).

Rounding follows `repro` as `jax.jit` compiles it. The scale is
max|g| / 127 + 1e-12, which XLA computes as fma(max|g|, f32(1/127),
f32(1e-12)), one rounding (as `models.common.kv_quantize` does); the
quotient g / scale rounds half to even (`jnp.round` and `torch.round`
both do) and clips to +-127. The residual fed - q * scale is fused as
well, into fma(-q, scale, fed).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.common import _EPS_12, _INV_127
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.to(torch.float32)
    top = torch.amax(torch.abs(gf))
    scale = (top.to(torch.float64) * _INV_127 + _EPS_12).to(torch.float32)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _residual(fed: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fed - q * scale with one rounding, as XLA fuses it into an fma: the
    product of an int8 and a float32 value is exact in float64."""
    exact = fed.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)
    return exact.to(torch.float32)


@torch.no_grad()
def compress_gradients(grads, error_state=None):
    """Returns ({"q": int8 tree, "scale": float32 scalar tree}, the new
    error state: the float32 residuals, a tree like `grads`)."""
    if error_state is None:
        error_state = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                     device=g.device), grads)
    fed = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error_state)
    pairs = [_quantize(f) for f in tree_leaves(fed)]
    qs = tree_unflatten(grads, [q for q, _ in pairs])
    scales = tree_unflatten(grads, [s for _, s in pairs])
    new_err = tree_map(_residual, fed, qs, scales)
    return {"q": qs, "scale": scales}, new_err


def decompress_gradients(comp):
    return tree_map(_dequantize, comp["q"], comp["scale"])
