"""Logical-axis sharding rules (port of `repro.models.sharding`).

Every parameter, activation and cache tensor carries a tuple of logical axis
names; the rules map each name to mesh axes. The same model code then lays
out on the single-pod (16x16 "data", "model") and multi-pod (2x16x16 "pod",
"data", "model") meshes, and on the small host meshes of the tests.

The port's PartitionSpec is a plain tuple with one entry a tensor dim: a
mesh-axis name, a tuple of names (the dim split over several mesh axes) or
None (replicated), as `jax.sharding.PartitionSpec` holds them. `placements`
turns it into DTensor placements over a `DeviceMesh` whose dim names are
the mesh axes. A dim split over a tuple of mesh axes is laid out major to
minor in the tuple's order, as JAX lays out `P(("pod", "data"))`: shard
index pod * n_data + data. DTensor splits a dim over several mesh dims in
mesh-dim order, so the tuple must name its axes in the mesh's order (every
rule here does); another order raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: logical axis -> mesh axis (or tuple of mesh axes), as in `repro`
BASE_RULES = {
    "batch": ("pod", "data"),  # data parallel over pod x data
    "seq": None,  # sequence kept unsharded by default (SP is a perf knob)
    "seq_shard": ("pod", "data"),  # sequence sharding for decode_* KV caches
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ffn": None,
    "layers": None,
    "conv": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "frames": None,
    "patches": None,
}


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a `DeviceMesh` (its dim names), or of anything with
    `axis_names` (a JAX mesh, a test's stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def rules_for_mesh(mesh, overrides: dict | None = None) -> dict:
    """Drop mesh axes that do not exist (e.g. 'pod' on the single-pod mesh)."""
    names = set(mesh_axis_names(mesh))
    out = {}
    rules = dict(BASE_RULES)
    if overrides:
        rules.update(overrides)
    for k, v in rules.items():
        if v is None:
            out[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            out[k] = kept if kept else None
        else:
            out[k] = v if v in names else None
    return out


def _entry(axes):
    """A spec entry as `PartitionSpec` holds it: a tuple of one axis is that
    axis."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def pspec(logical: Tuple[Optional[str], ...], rules: dict) -> tuple:
    """Map a tuple of logical axis names to a PartitionSpec (a tuple)."""
    return tuple(_entry(rules[a]) if a is not None else None for a in logical)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements over `mesh` of a PartitionSpec: Shard(i) on each
    mesh dim that tensor dim i names, Replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} names its mesh axes out of the mesh's "
                             f"order {names}: DTensor cannot lay it out as JAX does")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} is used twice in {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def is_logical_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_map_logical(fn, tree):
    """`fn` over the logical-axis tuples of a tree of dicts, lists and tuples."""
    if is_logical_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_logical(fn, v) for k, v in tree.items()}
    return type(tree)(tree_map_logical(fn, v) for v in tree)


def shardings(logical_tree, mesh, rules: dict | None = None):
    """Map a tree of logical-axis tuples to (PartitionSpec, placements) pairs."""
    rules = rules or rules_for_mesh(mesh)

    def one(logical):
        spec = pspec(logical, rules)
        return spec, placements(spec, mesh)

    return tree_map_logical(one, logical_tree)


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
