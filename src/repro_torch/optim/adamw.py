"""AdamW with global-norm clipping and a cosine schedule (port of
`repro.optim.adamw`).

`repro`'s own optimizer, not `torch.optim.AdamW`, whose clipping, schedule
and rounding differ. Parameters are a tree of tensors: dicts (walked in
sorted key order, as `jax.tree.leaves` walks them), lists and tuples; a
bf16 parameter is updated in float32 and rounded back, as `repro` does.
The step is a float32 computation on the parameters' device:

    scale = min(1, clip_norm / max(||g||, 1e-9))          global norm
    mu    = b1 * mu + (1 - b1) * g * scale
    nu    = b2 * nu + (1 - b2) * (g * scale) ** 2
    delta = (mu / (1 - b1 ** t)) / (sqrt(nu / (1 - b2 ** t)) + eps) + wd * p
    p     = p - lr(t) * delta

with `b1 ** t` in float32 and each product and sum in `repro`'s order. The
step counter is an int32 tensor on the device, so an update reads nothing
back to the host. `adamw_update` runs each operation once over all leaves
(`torch._foreach_*`) and returns new tensors; `adamw_update_` computes the
same values leaf by leaf into the caller's parameters and moments (the
port's form of `repro`'s donated buffers), so that no more than one leaf's
temporaries live at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in `jax.tree.leaves` order: a dict's values by
    sorted key, a list's or tuple's in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like `like` whose leaves are `leaves`, in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """`fn` over the leaves of `tree` (and of trees shaped like it)."""
    cols = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return tree_unflatten(tree, [fn(*c) for c in cols])


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), in float32: a linear warmup,
    then a cosine down to `min_lr_ratio * lr`."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params) -> dict:
    """Zero moments shaped like the parameters and a step of 0 (int32), on
    the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, the leaves
    added one after the other in `tree_leaves` order."""
    total = 0
    for g in tree_leaves(tree):
        g = g.to(torch.float32)
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def _schedule_terms(grads, state: dict, cfg: AdamWConfig):
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = step.to(torch.float32)
    return (step, gnorm, scale, cosine_schedule(cfg, step), 1 - torch.pow(cfg.b1, step_f),
            1 - torch.pow(cfg.b2, step_f))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig) -> Tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics); the inputs are not changed."""
    step, gnorm, scale, lr, b1c, b2c = _schedule_terms(grads, state, cfg)
    p = [x.to(torch.float32) for x in tree_leaves(params)]
    g = [x.to(torch.float32) for x in tree_leaves(grads)]
    # mu = b1 * mu + (1 - b1) * g * scale
    mu = torch._foreach_add(torch._foreach_mul(tree_leaves(state["mu"]), cfg.b1),
                            torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b1), scale))
    # nu = b2 * nu + (1 - b2) * gs * gs, gs = g * scale
    gs = torch._foreach_mul(g, scale)
    nu = torch._foreach_add(torch._foreach_mul(tree_leaves(state["nu"]), cfg.b2),
                            torch._foreach_mul(torch._foreach_mul(gs, 1 - cfg.b2), gs))
    # delta = mhat / (sqrt(nhat) + eps) + wd * p; p - lr * delta
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, b2c)), cfg.eps)
    delta = torch._foreach_add(torch._foreach_div(torch._foreach_div(mu, b1c), denom),
                               torch._foreach_mul(p, cfg.weight_decay))
    new_p = torch._foreach_sub(p, torch._foreach_mul(delta, lr))
    new_p = [x.to(old.dtype) for x, old in zip(new_p, tree_leaves(params))]
    new_state = {"mu": tree_unflatten(state["mu"], mu), "nu": tree_unflatten(state["nu"], nu),
                 "step": step}
    return tree_unflatten(params, new_p), new_state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_(params, grads, state: dict, cfg: AdamWConfig) -> Tuple[Any, dict, dict]:
    """`adamw_update` in place: the same values, written into `params` and
    `state`'s moments leaf by leaf (each operation in `adamw_update`'s
    order, so the bits are the same). Returns (params, state, metrics),
    the caller's trees."""
    step, gnorm, scale, lr, b1c, b2c = _schedule_terms(grads, state, cfg)
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        g = g.to(torch.float32)
        t = g * (1 - cfg.b1)
        t.mul_(scale)
        mu.mul_(cfg.b1).add_(t)
        gs = g * scale
        t = gs * (1 - cfg.b2)
        t.mul_(gs)
        nu.mul_(cfg.b2).add_(t)
        denom = nu / b2c
        denom.sqrt_().add_(cfg.eps)
        delta = mu / b1c
        delta.div_(denom).add_(p.to(torch.float32) * cfg.weight_decay)
        delta.mul_(lr)
        p.copy_(p.to(torch.float32) - delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
