"""Mixture-of-Experts FFN (PyTorch): fine-grained routed experts and optional
shared experts. Counterpart of `repro.models.moe`.

Covers deepseek-moe-16b (2 shared + 64 routed, top-6) and qwen3-moe-30b-a3b
(128 routed, top-8). Dispatch is capacity based: each token's top-k slots
are placed into per-expert buffers [E, C, d] by their position in their
expert (slots in token-major, then k, order), every expert runs its gated MLP on its whole buffer (empty
rows included), and the outputs are gathered back and combined with the
renormalised router weights. The router runs in float32; a switch-style
load-balancing aux loss is returned beside the output.

`moe_ffn` is `repro`'s grouped form and `moe_ffn_global` its global-buffer
baseline (taken when `REPRO_MOE_GROUPED=0`). The two differ only in the
combine: the grouped form rounds the router weights to bf16 before the
product, the global one keeps them in float32. With no mesh there is one
dispatch group (G = 1). Under a mesh (`launch.mesh.set_mesh_compat`, the
input a DTensor) G is the product of the data axes when G > 1 and it
divides the tokens (`_dp_group_count`), and capacity is taken per group,
`capacity(n // G)`: G changes which slots are dropped, so an MoE model on
a mesh of 2 data ranks computes `repro`'s G = 2 function. The meshed
dispatch (`_moe_meshed`) has no DTensor strategy for its sort, scatters and
top-k, so it runs on local tensors with its collectives written out: each
data rank routes its own group's tokens (the rows of its batch shard), the
model ranks each run their own slice of the experts on that group's
buffer, and an all-gather over "model" brings every expert's rows back for
the combine. That is `repro`'s [G, E, C, d] -> [E, G·C, d] exchange and
back with the redundant work left out: in `repro`'s layout each expert
shard computes every group's rows and keeps its own group's. The global
baseline has no groups to run on local tensors and raises under a mesh.
`MoEConfig.shard_constraints` is kept as a field; the meshed dispatch lays
the tokens and buffers out as its hints would, with or without it.

Rounding follows `repro`'s MoE as XLA compiles it (`jax.jit`, or inside
`lax.scan`), which is how `repro` always runs it: the expert gate product
reaches silu/gelu in float32, unrounded; every other expert product is
rounded to bf16. The combine sums the k weighted slots in float32 and
rounds once; the grouped form's weighted slot (a bf16 product in `repro`)
is rounded to bf16 before that sum, the global form's is not. Shared
experts go through `common.gated_mlp` and are added in bf16.

Capacity: a slot is kept while its position in its expert is below C =
`capacity(n_tokens, cfg)` (at least 8); later slots are dropped and add
nothing. `REPRO_MOE_CF` overrides the capacity factor, as in `repro`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import ambient_mesh, submesh
from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN width (fine-grained)
    n_shared: int = 0  # shared (always-on) experts of the same width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    #: `repro`'s sharding hints around the dispatch; a no-op on one device
    shard_constraints: bool = os.environ.get("REPRO_MOE_CONSTRAIN", "1") == "1"


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig) -> Dict[str, torch.Tensor]:
    """Random MoE parameters: the router float32, the experts bf16."""
    e, f = cfg.n_experts, cfg.d_expert
    p = {
        "router": cm.ninit(generator, (d_model, e), d_model, torch.float32),
        "wg": cm.ninit(generator, (e, d_model, f), d_model),
        "wu": cm.ninit(generator, (e, d_model, f), d_model),
        "wd": cm.ninit(generator, (e, f, d_model), f),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared_wg"] = cm.ninit(generator, (d_model, fs), d_model)
        p["shared_wu"] = cm.ninit(generator, (d_model, fs), d_model)
        p["shared_wd"] = cm.ninit(generator, (fs, d_model), fs)
    return p


def moe_logical(cfg: MoEConfig) -> Dict[str, Tuple[str, ...]]:
    spec = {
        "router": ("embed", "experts"),
        "wg": ("experts", "embed", "expert_ffn"),
        "wu": ("experts", "embed", "expert_ffn"),
        "wd": ("experts", "expert_ffn", "embed"),
    }
    if cfg.n_shared:
        spec["shared_wg"] = ("embed", "ffn")
        spec["shared_wu"] = ("embed", "ffn")
        spec["shared_wd"] = ("ffn", "embed")
    return spec


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert holds for `n_tokens` tokens: ceil(n k cf / E), rounded
    up to a multiple of 8, at least 8."""
    cf = float(os.environ.get("REPRO_MOE_CF", cfg.capacity_factor))
    c = int(np.ceil(n_tokens * cfg.top_k * cf / cfg.n_experts))
    return max(8, int(np.ceil(c / 8) * 8))


def _dp_group_count(n_tokens: int, mesh=None) -> int:
    """Number of data shards (dispatch groups) of the ambient mesh: the
    product of the data axes, 1 when that is 1 or does not divide the
    tokens."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return 1
    g = 1
    for a, size in zip(mesh.mesh_dim_names, mesh.shape):
        if a in ("pod", "data"):
            g *= int(size)
    return g if g > 1 and n_tokens % g == 0 else 1


class Routing(NamedTuple):
    """The router's decision for N tokens, slots in token-major, then k, order."""

    probs: torch.Tensor  # [N, E] float32
    top_w: torch.Tensor  # [N, k] float32, renormalised
    top_ids: torch.Tensor  # [N, k] int64
    keep: torch.Tensor  # [N * k] bool: the slot fits in its expert
    slot: torch.Tensor  # [N * k] int64: row of the [E * C] buffer


def select_experts(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights, ids) [N, k] of each token's top-k experts, the weights
    renormalised to sum to 1 (by at least 1e-9)."""
    top_w, top_ids = torch.topk(probs, k, dim=-1)
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_ids


def expert_counts(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Slots an expert, int64 [E] (integer adds: exact in any order, no host
    sync as `bincount` would need on the card)."""
    return torch.zeros(n_experts, dtype=torch.long, device=flat_ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))


def position_in_expert(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """For each slot, how many earlier slots chose the same expert: `repro`'s
    cumulative sum of one-hot rows, taken as a stable sort by expert
    instead (the same integers; a scan down [N * k, E] one-hot columns is
    slow on the card)."""
    order = torch.sort(flat_ids, stable=True).indices
    counts = expert_counts(flat_ids, n_experts)
    starts = torch.cumsum(counts, 0) - counts  # first sorted row of each expert
    ranks = torch.arange(flat_ids.numel(), device=flat_ids.device) - starts[flat_ids[order]]
    return torch.empty_like(flat_ids).scatter_(0, order, ranks)


def route(xf: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, c: int) -> Routing:
    """Top-k routing of tokens xf [N, d] into buffers of `c` rows an expert."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = select_experts(probs, cfg.top_k)
    e = cfg.n_experts
    flat_ids = top_ids.reshape(-1)
    pos = position_in_expert(flat_ids, e)
    keep = pos < c
    slot = torch.clamp(flat_ids * c + pos, 0, e * c - 1)
    return Routing(probs, top_w, top_ids, keep, slot)


def aux_loss(r: Routing, cfg: MoEConfig) -> torch.Tensor:
    """Switch load-balance loss: weight * E * sum_e f_e p_e (float32 scalar)."""
    e = cfg.n_experts
    f_e = expert_counts(r.top_ids.reshape(-1), e).to(torch.float32) / r.top_ids.numel()
    p_e = r.probs.mean(dim=0)
    return cfg.router_aux_weight * e * torch.sum(f_e * p_e)


class _BmmF32(torch.autograd.Function):
    """a @ b of bf16 batches with the float32 accumulator kept, not rounded
    to bf16: cuBLAS's bf16 product with a float32 output on the card, a
    float32 product of the same (exact) values elsewhere. Its backward is
    JAX's of `repro`'s bf16 einsum: the float32 cotangent rounded to the
    inputs' dtype, then the two transposed bf16 products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.ops.aten.bmm.dtype(a, b, torch.float32)
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        return torch.bmm(grad, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), grad)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _BmmF32.apply(a, b)


def _experts(buf: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Every expert's gated MLP on its buffer rows: [E, C, d] -> [E, C, d].
    The gate product enters the activation unrounded, as XLA fuses it in
    `repro`'s compiled MoE; the activation is rounded to bf16."""
    h = _bmm_f32(buf, p["wg"])
    hu = torch.bmm(buf, p["wu"])
    if act == "silu":
        h = F.silu(h).to(buf.dtype)
    else:
        h = F.gelu(h, approximate="tanh").to(buf.dtype)
    return torch.bmm(h * hu, p["wd"])


def _moe(x: torch.Tensor, p: dict, cfg: MoEConfig, act: str, bf16_weights: bool):
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    c = capacity(n, cfg)
    xf = x.reshape(n, d)
    r = route(xf, p["router"], cfg, c)
    aux = aux_loss(r, cfg)

    # dispatch: each kept slot writes its own buffer row (no two share one);
    # dropped slots write a spare row past the buffer, which is cut off
    tok_idx = torch.arange(n * k, device=x.device) // k
    rows = torch.where(r.keep, r.slot, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, rows, xf[tok_idx])
    out = _experts(buf[:e * c].reshape(e, c, d), p, act).reshape(e * c, d)

    # combine: gather back, weight, sum over the k slots in float32, round once
    gathered = torch.where(r.keep[:, None], out[r.slot], 0)
    if bf16_weights:
        weighted = (gathered * r.top_w.reshape(-1, 1).to(x.dtype)).to(torch.float32)
    else:
        weighted = gathered.to(torch.float32) * r.top_w.reshape(-1, 1)
    y = weighted.reshape(n, k, d).sum(dim=1).to(x.dtype)
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        y = y + cm.gated_mlp(x, p["shared_wg"], p["shared_wu"], p["shared_wd"], act)
    return y, aux


def _meshed(x: torch.Tensor):
    """The ambient mesh when `x` is a DTensor on it, else None."""
    mesh = ambient_mesh()
    return mesh if mesh is not None and cm.is_dtensor(x) else None


def _moe_meshed(x, p: dict, cfg: MoEConfig, act: str, mesh):
    """Grouped dispatch over `mesh` (see the module docstring): x a DTensor
    [B, S, d] -> (y DTensor [B, S, d] laid out with the batch over the data
    axes, aux a replicated float32 DTensor scalar)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    g = _dp_group_count(n, mesh)
    if g > 1 and b % g:
        raise NotImplementedError(f"{n} tokens make {g} dispatch groups but the batch of "
                                  f"{b} rows does not split over the data axes")
    grouped = g > 1
    # which mesh dims split the experts (Shard(0) of the expert weights)
    ep_dims = [i for i, pl in enumerate(p["wg"].placements) if pl == Shard(0)]
    rep = Replicate()

    def lay(on_dp, on_ep, other=rep):
        return tuple(on_dp if i in dp else (on_ep if i in ep_dims else other)
                     for i in range(len(names)))

    tokens = lay(Shard(0) if grouped else rep, rep)
    x = x.redistribute(mesh, tokens)
    m = n // g
    c = capacity(m, cfg)
    dp_sum = Partial() if grouped else rep
    # routing is computed alike on every expert rank (its gradient is
    # replicated there); the dispatch feeds this rank's experts only (its
    # gradient is a partial sum over them); weights see this group only
    xr = x.to_local().reshape(m, d)
    xd = x.to_local(grad_placements=lay(Shard(0) if grouped else rep, Partial())).reshape(m, d)
    router = p["router"].redistribute(mesh, (rep,) * len(names)).to_local(
        grad_placements=lay(dp_sum, rep))
    w = {name: p[name].to_local(grad_placements=lay(dp_sum, Shard(0)))
         for name in ("wg", "wu", "wd")}
    r = route(xr, router, cfg, c)

    # aux over every group's tokens: counts and router probabilities summed
    # over the data axes
    counts = expert_counts(r.top_ids.reshape(-1), e).to(torch.float32)
    p_sum = r.probs.sum(dim=0)
    if grouped:
        counts = DTensor.from_local(counts, mesh, lay(Partial(), rep), run_check=False)
        counts = counts.redistribute(mesh, (rep,) * len(names)).to_local()
        p_sum = DTensor.from_local(p_sum, mesh, lay(Partial(), rep), run_check=False)
        p_sum = p_sum.redistribute(mesh, (rep,) * len(names)).to_local()
    aux = cfg.router_aux_weight * e * torch.sum((counts / (n * k)) * (p_sum / n))

    # dispatch this group's slots; run this rank's experts on them
    n_ep = 1
    for i in ep_dims:
        n_ep *= mesh.size(i)
    e_loc = e // n_ep
    j = 0
    coord = mesh.get_coordinate()
    for i in ep_dims:
        j = j * mesh.size(i) + coord[i]
    tok_idx = torch.arange(m * k, device=xd.device) // k
    rows = torch.where(r.keep, r.slot, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=xd.dtype, device=xd.device)
    buf.index_copy_(0, rows, xd[tok_idx])
    mine = buf[:e * c].reshape(e, c, d)[j * e_loc:(j + 1) * e_loc]
    out = _experts(mine, w, act)  # [E_loc, C, d]
    if ep_dims:
        # every expert's rows for the combine: an all-gather over the expert
        # ranks, whose consumers are alike there (its backward a slice)
        sub = submesh(mesh, [names[i] for i in ep_dims])
        out = DTensor.from_local(out, sub, (Shard(0),), run_check=False).full_tensor()
    out = out.reshape(e * c, d)

    gathered = torch.where(r.keep[:, None], out[r.slot], 0)
    weighted = (gathered * r.top_w.reshape(-1, 1).to(xd.dtype)).to(torch.float32)
    y = weighted.reshape(m, k, d).sum(dim=1).to(xd.dtype)
    y = DTensor.from_local(y.reshape(x.to_local().shape), mesh, tokens, run_check=False)
    if cfg.n_shared:
        y = y + cm.gated_mlp(x, p["shared_wg"], p["shared_wu"], p["shared_wd"], act)
    aux = DTensor.from_local(aux, mesh, (rep,) * len(names), run_check=False)
    return y, aux


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoEConfig,
            act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped dispatch. x [B, S, d] -> (y [B, S, d], aux loss float32
    scalar): one group on one device, `_moe_meshed` under a mesh.
    `REPRO_MOE_GROUPED=0` takes `moe_ffn_global`."""
    if os.environ.get("REPRO_MOE_GROUPED", "1") != "1":
        return moe_ffn_global(x, p, cfg, act)
    mesh = _meshed(x)
    if mesh is not None:
        return _moe_meshed(x, p, cfg, act, mesh)
    return _moe(x, p, cfg, act, bf16_weights=True)


def moe_ffn_global(x: torch.Tensor, p: dict, cfg: MoEConfig,
                   act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-capacity dispatch: x [B, S, d] -> (y [B, S, d], aux). One
    device only: its one buffer for every token has no local form."""
    if _meshed(x) is not None:
        raise NotImplementedError("the global-capacity MoE dispatch (REPRO_MOE_GROUPED=0) "
                                  "runs on one device; under a mesh use the grouped one")
    return _moe(x, p, cfg, act, bf16_weights=False)


def dense_reference(x: torch.Tensor, p: dict, cfg: MoEConfig,
                    act: str = "silu") -> torch.Tensor:
    """The dense oracle: every expert on every token (no capacity, nothing
    dropped), combined by the renormalised top-k router weights in float32,
    plus the shared experts. x [B, S, d] -> [B, S, d]. A plain reference for
    tests; it computes E / k times the routed work."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.to(torch.float32) @ p["router"].to(torch.float32), dim=-1)
    w, ids = select_experts(probs, cfg.top_k)
    h = torch.einsum("nd,edf->enf", xf, p["wg"])
    hu = torch.einsum("nd,edf->enf", xf, p["wu"])
    if act == "silu":
        h = F.silu(h.to(torch.float32)).to(x.dtype)
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    out = torch.einsum("enf,efd->end", h * hu, p["wd"])  # [E, N, d]
    tokens = torch.arange(xf.shape[0], device=x.device)[:, None]
    comb = out.transpose(0, 1)[tokens, ids].to(torch.float32)  # [N, k, d]
    y = (comb * w[..., None]).sum(dim=1).to(x.dtype).reshape(b, s, d)
    if cfg.n_shared:
        y = y + cm.gated_mlp(x, p["shared_wg"], p["shared_wu"], p["shared_wd"], act)
    return y
