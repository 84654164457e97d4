"""Training and serving steps, on one device or over a mesh (port of
`repro.launch.steps`).

`build_train_step` returns `train_step(params, opt_state, batch) ->
(params, opt_state, {"loss", "grad_norm", "lr"})`: the loss and its
gradient by autograd (`ModelDef.loss`), then `repro`'s AdamW
(`optim.adamw`). With `microbatch > 1` the batch's rows split into that
many consecutive slices, whose losses and gradients add up in float32
(bf16 under `REPRO_GRAD_ACC_BF16=1`), slice after slice, and are divided
by `microbatch`, as `repro`'s scan does. With `donate` (the default) the
step updates the caller's parameters and moments in place, the port's form
of `repro`'s donated buffers; without it they are left as they were.

With `mesh=None` (the default) every step runs on one device. Given a mesh
(`launch.mesh`, a `DeviceMesh` named "pod"/"data"/"model"), every tensor is
a DTensor laid out as `repro` lays it out (`safe_sharding`, the rules of
`models.sharding`): the parameters by their logical axes; the AdamW moments
ZeRO-1, their "embed" dim also over the data axes; the batch over the data
axes. The step then runs `repro`'s schedule: the gradients (partial sums
over the data axes) are reduce-scattered into the moments' layout, AdamW
updates each rank's shard, and the fresh parameters are all-gathered back
into theirs. A microbatch is `repro`'s global slice of rows, laid out
over the data axes again (the batch's token ids are gathered for it). The
prefill and decode steps take `repro`'s layouts too, the decode cache's
sequence over "model" (over every axis when the batch does not divide).
`BuiltStep.in_shardings`/`out_shardings` hold the layouts (a `Sharding`
a leaf); `shard_tree` puts a tree of full tensors into them.

The model code runs on DTensors (under `implicit_replication`, which takes
the plain tensors it makes, positions and masks, as replicated), each
layer's output pinned to the token layout, its gradient with it
(`common.pinned_tokens`). Where DTensor has no sharding strategy, or one
its backward cannot propagate, the module runs on local tensors and writes
out its collective: the vocab-parallel lookup and cross entropy
(`common._embed_local`, `common._vocab_parallel_ce_sum`), attention on each
rank's heads, the flash kernel included (`common._attention_local_heads`),
the MoE dispatch groups (`models.moe`), the SSD (`models.ssm`), the vlm
projector and the decode cache's one-token write
(`decoder._write_token_sharded`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.launch.mesh import set_mesh_compat
from repro_torch.models import sharding as sh
from repro_torch.models.decoder import TensorSpec
from repro_torch.models.registry import ModelDef
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, adamw_update_, tree_leaves,
                                     tree_unflatten)


@dataclasses.dataclass
class BuiltStep:
    fn: Callable  # the step
    batch_shapes: Any  # {name: TensorSpec} of the batch it takes (make_inputs)
    description: str
    in_shardings: Any = None  # a tree of `Sharding` an argument (None on one device)
    out_shardings: Any = None  # a tree of `Sharding` a result
    mesh: Any = None


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout over a mesh: `repro`'s `NamedSharding`. `spec` is a
    PartitionSpec (`models.sharding`), `placements` its DTensor placements."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return sh.placements(self.spec, self.mesh)


def _axes_size(mesh, axes) -> int:
    sizes = sh.mesh_shape(mesh)
    n = 1
    for a in sh.spec_axes(axes):
        n *= sizes[a]
    return n


def safe_sharding(mesh, sds, logical, rules) -> Sharding:
    """Logical spec -> Sharding. Drops assignments that do not divide the
    dim, and (first come, first served) assignments whose mesh axis an
    earlier dim of the same tensor already uses (e.g. decode caches map both
    seq and kv_heads to 'model'; seq wins, kv_heads falls back to
    replicated)."""
    parts = []
    used: set = set()
    for dim, name in zip(tuple(sds.shape), logical):
        axes = rules.get(name) if name is not None else None
        if axes is not None:
            ax_tuple = tuple(a for a in sh.spec_axes(axes) if a not in used)
            axes = ax_tuple if len(ax_tuple) > 1 else (ax_tuple[0] if ax_tuple else None)
        if axes is not None and dim > 0 and dim % _axes_size(mesh, axes) == 0:
            parts.append(axes)
            used.update(sh.spec_axes(axes))
        else:
            parts.append(None)
    return Sharding(mesh, tuple(parts))


def _is_shape_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, TensorSpec))


def tree_shardings(mesh, shape_tree, logical_tree, rules):
    """`safe_sharding` of each leaf of `shape_tree` (tensors or
    `TensorSpec`s) with the logical axes at the same place of
    `logical_tree`."""
    if _is_shape_leaf(shape_tree):
        if not sh.is_logical_leaf(logical_tree):
            raise ValueError(f"no logical axes for a leaf of shape {tuple(shape_tree.shape)}")
        return safe_sharding(mesh, shape_tree, logical_tree, rules)
    if isinstance(shape_tree, dict):
        return {k: tree_shardings(mesh, v, logical_tree[k], rules)
                for k, v in shape_tree.items()}
    if len(shape_tree) != len(logical_tree):
        raise ValueError(f"{len(shape_tree)} leaves against {len(logical_tree)} logical specs")
    return type(shape_tree)(tree_shardings(mesh, v, l, rules)
                            for v, l in zip(shape_tree, logical_tree))


def shard_tensor(t: torch.Tensor, layout: Sharding):
    """`t` (a full tensor, the same on every rank, or a DTensor) in `layout`:
    each rank keeps its own slice, with no communication for a full one, in
    storage of its own (never a view of `t`)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(layout.mesh, layout.placements)
    out = distribute_tensor(t, layout.mesh, layout.placements, src_data_rank=None)
    if out.to_local().untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        # its own storage: a donating step writes its shards in place
        out = DTensor.from_local(out.to_local().clone(), layout.mesh, layout.placements,
                                 run_check=False, shape=out.shape, stride=out.stride())
    return out


def shard_tree(tree, shardings):
    """`shard_tensor` over a tree and a tree of `Sharding`s like it."""
    return tree_unflatten(tree, [shard_tensor(t, s) for t, s in
                                 zip(tree_leaves(tree), tree_leaves(shardings))])


def full_tree(tree):
    """The full tensors of a tree of DTensors (an all-gather each), plain
    tensors as they are."""
    from torch.distributed.tensor import DTensor

    return tree_unflatten(tree, [t.full_tensor() if isinstance(t, DTensor) else t
                                 for t in tree_leaves(tree)])


def _opt_logical(param_logical):
    return {"mu": param_logical, "nu": param_logical, "step": ()}


def _in_mesh(mesh):
    """The context of a meshed step: plain tensors the model code makes are
    replicated DTensors, and `models.moe` sees the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(set_mesh_compat(mesh))
    return stack


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


def build_train_step(model: ModelDef, shape, mesh=None, opt_cfg: Optional[AdamWConfig] = None,
                     rules_overrides: Optional[dict] = None, donate: bool = True,
                     microbatch: int = 1) -> BuiltStep:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    for `shape` (an `InputShape` of mode "train"), on one device or over
    `mesh` (see the module docstring)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if shape.global_batch % microbatch:
        raise ValueError(f"batch {shape.global_batch} is not a multiple of "
                         f"microbatch {microbatch}")
    if mesh is not None:
        return _build_sharded_train_step(model, shape, mesh, opt_cfg, rules_overrides, donate,
                                         microbatch)
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


def train_layouts(model: ModelDef, shape, mesh, rules_overrides: Optional[dict] = None):
    """(parameters, moments, batch) layouts of the meshed train step:
    `repro`'s, the moments ZeRO-1 ("embed" also over the data axes)."""
    rules = sh.rules_for_mesh(mesh, rules_overrides)
    opt_rules = sh.rules_for_mesh(mesh, {**(rules_overrides or {}), "embed": ("pod", "data")})
    params_shapes = model.param_shapes()
    logical = model.param_logical()
    batch_shapes, batch_logical = model.make_inputs("train", shape.global_batch, shape.seq_len)
    p_sh = tree_shardings(mesh, params_shapes, logical, rules)
    m_sh = tree_shardings(mesh, params_shapes, logical, opt_rules)
    o_sh = {"mu": m_sh, "nu": m_sh, "step": Sharding(mesh, ())}
    b_sh = tree_shardings(mesh, batch_shapes, batch_logical, rules)
    return p_sh, o_sh, b_sh


def _sharded_microbatches(batch, n: int):
    """The n consecutive row slices of every batch DTensor (`repro`'s
    microbatches: slice m is global rows [m B/n, (m+1) B/n), whichever
    ranks hold them), each laid out as the batch (its rows over the data
    axes where they divide, else replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    for m in range(n):
        out = {}
        for k, v in batch.items():
            rows = v.shape[0] // n
            mesh, lay = v.device_mesh, list(v.placements)
            split = 1
            for i, pl in enumerate(lay):
                if pl == Shard(0):
                    split *= mesh.size(i)
            if rows % split:
                lay = [Replicate() if pl == Shard(0) else pl for pl in lay]
            out[k] = v[m * rows:(m + 1) * rows].redistribute(mesh, lay)
        yield out


def _row_major(t):
    """DTensor `t` with its local shard in row-major order. A reduce-scatter
    into a dim other than the first can hand back a transposed view, and
    the global norm's sum over it would add in another order than one
    device's sum over the same values."""
    from torch.distributed.tensor import DTensor

    loc = t.to_local()
    if loc.is_contiguous():
        return t
    return DTensor.from_local(loc.contiguous(), t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _build_sharded_train_step(model, shape, mesh, opt_cfg, rules_overrides, donate,
                              microbatch) -> BuiltStep:
    p_sh, o_sh, b_sh = train_layouts(model, shape, mesh, rules_overrides)
    batch_shapes, _ = model.make_inputs("train", shape.global_batch, shape.seq_len)
    scalar = Sharding(mesh, ())
    m_sh = {"loss": scalar, "grad_norm": scalar, "lr": scalar}
    p_layouts, m_layouts = tree_leaves(p_sh), tree_leaves(o_sh["mu"])

    def train_step(params, opt_state, batch):
        with _in_mesh(mesh):
            if microbatch > 1:
                acc_dtype = (torch.bfloat16 if os.environ.get("REPRO_GRAD_ACC_BF16") == "1"
                             else torch.float32)
                loss, acc = None, None
                for mb in _sharded_microbatches(batch, microbatch):
                    l_mb, g_mb = value_and_grad(model, params, mb)
                    g_mb = [g.to(acc_dtype) for g in tree_leaves(g_mb)]
                    loss = l_mb if loss is None else loss + l_mb
                    acc = g_mb if acc is None else [a + g for a, g in zip(acc, g_mb)]
                loss = loss / microbatch
                grads = [g / microbatch for g in acc]
            else:
                loss, grads = value_and_grad(model, params, batch)
                grads = tree_leaves(grads)
            # ZeRO-1: reduce-scatter the gradients into the moments' layout,
            # update each rank's shard, all-gather the fresh parameters
            grads = [_row_major(g.redistribute(mesh, s.placements))
                     for g, s in zip(grads, m_layouts)]
            shards = [p.redistribute(mesh, s.placements)
                      for p, s in zip(tree_leaves(params), m_layouts)]
            update = adamw_update_ if donate else adamw_update
            shards, new_opt, metrics = update(shards, grads, opt_state, opt_cfg)
            fresh = [x.redistribute(mesh, s.placements) for x, s in zip(shards, p_layouts)]
            if donate:
                for p, x in zip(tree_leaves(params), fresh):
                    p.copy_(x)
                new_params = params
            else:
                new_params = tree_unflatten(params, fresh)
            loss = loss.redistribute(mesh, scalar.placements)
        return new_params, new_opt, {"loss": loss, **metrics}

    return BuiltStep(fn=train_step, batch_shapes=batch_shapes,
                     description=f"train_step[{model.name} x {shape.name}]",
                     in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, m_sh),
                     mesh=mesh)


def _logits_sharding(model: ModelDef, mesh, batch: int, rules) -> Sharding:
    """logits [B, 1, V]: batch over the data axes, vocab over "model"."""
    return safe_sharding(mesh, TensorSpec((batch, 1, model.vocab), torch.float32),
                         ("batch", None, "vocab"), rules)


def build_prefill_step(model: ModelDef, shape, mesh=None,
                       rules_overrides: Optional[dict] = None) -> BuiltStep:
    """prefill(params, batch) -> next-token logits [B, 1, V]."""
    batch_shapes, batch_logical = model.make_inputs("prefill", shape.global_batch,
                                                    shape.seq_len)
    description = f"prefill[{model.name} x {shape.name}]"
    if mesh is None:
        return BuiltStep(fn=lambda params, batch: model.prefill(params, batch),
                         batch_shapes=batch_shapes, description=description)
    rules = sh.rules_for_mesh(mesh, rules_overrides)
    p_sh = tree_shardings(mesh, model.param_shapes(), model.param_logical(), rules)
    b_sh = tree_shardings(mesh, batch_shapes, batch_logical, rules)
    l_sh = _logits_sharding(model, mesh, shape.global_batch, rules)

    def prefill(params, batch):
        with _in_mesh(mesh):
            return model.prefill(params, batch).redistribute(mesh, l_sh.placements)

    return BuiltStep(fn=prefill, batch_shapes=batch_shapes, description=description,
                     in_shardings=(p_sh, b_sh), out_shardings=l_sh, mesh=mesh)


def decode_rules(mesh, shape, rules_overrides: Optional[dict] = None) -> dict:
    """`repro`'s decode rules: the cache's sequence over "model" (kv heads
    rarely divide it), or, when the batch does not divide the data axes
    (long_500k's batch of 1), over every axis with the batch replicated."""
    rules = dict(sh.rules_for_mesh(mesh, rules_overrides))
    dp = sh.dp_axes(mesh)
    if shape.global_batch % _axes_size(mesh, dp):
        rules["seq"] = dp + ("model",)
        rules["batch"] = None
    else:
        rules["seq"] = ("model",)
    return rules


def build_decode_step(model: ModelDef, shape, mesh=None,
                      rules_overrides: Optional[dict] = None) -> BuiltStep:
    """decode(params, cache, batch) -> (logits [B, 1, V], cache): one new
    token against a cache of shape.seq_len rows, written in place."""
    batch_shapes, batch_logical = model.make_inputs("decode", shape.global_batch,
                                                    shape.seq_len)
    description = f"decode[{model.name} x {shape.name}]"
    if mesh is None:
        return BuiltStep(fn=lambda params, cache, batch: model.decode_step(params, cache, batch),
                         batch_shapes=batch_shapes, description=description)
    rules = decode_rules(mesh, shape, rules_overrides)
    p_sh = tree_shardings(mesh, model.param_shapes(), model.param_logical(), rules)
    b_sh = tree_shardings(mesh, batch_shapes, batch_logical, rules)
    c_sh = tree_shardings(mesh, model.init_cache_shape(shape.global_batch, shape.seq_len),
                          model.cache_logical(), rules)
    l_sh = _logits_sharding(model, mesh, shape.global_batch, rules)

    def decode(params, cache, batch):
        with _in_mesh(mesh):
            logits, cache = model.decode_step(params, cache, batch)
            return logits.redistribute(mesh, l_sh.placements), cache

    return BuiltStep(fn=decode, batch_shapes=batch_shapes, description=description,
                     in_shardings=(p_sh, c_sh, b_sh), out_shardings=(l_sh, c_sh), mesh=mesh)


def build_step(model: ModelDef, shape, mesh=None, **kw) -> BuiltStep:
    if shape.mode == "train":
        return build_train_step(model, shape, mesh, **kw)
    if shape.mode == "prefill":
        return build_prefill_step(model, shape, mesh, **kw)
    return build_decode_step(model, shape, mesh, **kw)
