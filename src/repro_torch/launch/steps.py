"""Training and serving steps on one device (port of `repro.launch.steps`).

`build_train_step` returns `train_step(params, opt_state, batch) ->
(params, opt_state, {"loss", "grad_norm", "lr"})`: the loss and its
gradient by autograd (`ModelDef.loss`), then `repro`'s AdamW
(`optim.adamw`). With `microbatch > 1` the batch's rows split into that
many consecutive slices, whose losses and gradients add up in float32
(bf16 under `REPRO_GRAD_ACC_BF16=1`), slice after slice, and are divided
by `microbatch`, as `repro`'s scan does. With `donate` (the default) the
step updates the caller's parameters and moments in place, the port's form
of `repro`'s donated buffers; without it they are left as they were.

There is no mesh and no sharding here: `repro`'s `build_train_step` lays
the AdamW moments out ZeRO-1 over the data axes, and that layout comes with
`models/sharding.py` and the N-rank step on `torch.distributed`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.models.registry import ModelDef
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, adamw_update_, tree_leaves,
                                     tree_unflatten)


@dataclasses.dataclass
class BuiltStep:
    fn: Callable  # the step
    batch_shapes: Any  # {name: TensorSpec} of the batch it takes (make_inputs)
    description: str


def value_and_grad(model: ModelDef, params, batch):
    """(loss, gradient tree like `params`) of `model.loss` by autograd. The
    caller's tensors keep their `requires_grad`; a parameter the loss does
    not reach gets a zero gradient, as JAX gives one."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(tree_unflatten(params, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def _microbatches(batch, n: int):
    """The n consecutive row slices of every batch tensor."""
    for m in range(n):
        yield {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[m]
               for k, v in batch.items()}


def build_train_step(model: ModelDef, shape, opt_cfg: Optional[AdamWConfig] = None,
                     donate: bool = True, microbatch: int = 1) -> BuiltStep:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    for `shape` (an `InputShape` of mode "train"; see the module docstring)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if shape.global_batch % microbatch:
        raise ValueError(f"batch {shape.global_batch} is not a multiple of "
                         f"microbatch {microbatch}")
    batch_shapes, _ = model.make_inputs("train", shape.global_batch, shape.seq_len)
    update = adamw_update_ if donate else adamw_update

    def train_step(params, opt_state, batch):
        if microbatch > 1:
            acc_dtype = (torch.bfloat16 if os.environ.get("REPRO_GRAD_ACC_BF16") == "1"
                         else torch.float32)
            leaves = tree_leaves(params)
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in leaves]
            for mb in _microbatches(batch, microbatch):
                l_mb, g_mb = value_and_grad(model, params, mb)
                loss = loss + l_mb
                acc = [a + g.to(acc_dtype) for a, g in zip(acc, tree_leaves(g_mb))]
            loss = loss / microbatch
            grads = tree_unflatten(params, [g / microbatch for g in acc])
        else:
            loss, grads = value_and_grad(model, params, batch)
        new_params, new_opt, metrics = update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss, **metrics}

    return BuiltStep(fn=train_step, batch_shapes=batch_shapes,
                     description=f"train_step[{model.name} x {shape.name}]")


def build_prefill_step(model: ModelDef, shape) -> BuiltStep:
    """prefill(params, batch) -> next-token logits [B, 1, V]."""
    batch_shapes, _ = model.make_inputs("prefill", shape.global_batch, shape.seq_len)
    return BuiltStep(fn=lambda params, batch: model.prefill(params, batch),
                     batch_shapes=batch_shapes,
                     description=f"prefill[{model.name} x {shape.name}]")


def build_decode_step(model: ModelDef, shape) -> BuiltStep:
    """decode(params, cache, batch) -> (logits [B, 1, V], cache): one new
    token against a cache of shape.seq_len rows, written in place."""
    batch_shapes, _ = model.make_inputs("decode", shape.global_batch, shape.seq_len)
    return BuiltStep(fn=lambda params, cache, batch: model.decode_step(params, cache, batch),
                     batch_shapes=batch_shapes,
                     description=f"decode[{model.name} x {shape.name}]")


def build_step(model: ModelDef, shape, **kw) -> BuiltStep:
    if shape.mode == "train":
        return build_train_step(model, shape, **kw)
    if shape.mode == "prefill":
        return build_prefill_step(model, shape, **kw)
    return build_decode_step(model, shape, **kw)
