"""Mesh construction (port of `repro.launch.mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the current process group, its dims named as `repro`'s mesh axes ("pod",
"data", "model"). Functions, not module-level constants: importing this
module touches no process group and no device.

The device type follows the process group: "cuda" under NCCL, else the
CPU (gloo, and the dry run's fake world). Two gloo ranks sharing one card
pass `device_type="cuda"` themselves.

`set_mesh_compat` installs the ambient mesh that `models.moe` reads for its
dispatch groups, the port's counterpart of `jax.set_mesh`.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch.distributed as dist

_AMBIENT = threading.local()


def world_size() -> int:
    """The ranks of the default process group, 1 when none is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def default_device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_compat_mesh(shape, axes, device_type: str | None = None):
    """A DeviceMesh of `shape` named `axes` over the whole world. Raises when
    the world's size is not the product of `shape`, as `jax.make_mesh`
    raises on too few devices."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    need, have = math.prod(shape), world_size()
    if need != have:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs {need} ranks; "
                         f"the world has {have}")
    if not dist.is_initialized():
        raise RuntimeError("make_compat_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return init_device_mesh(device_type or default_device_type(), shape, mesh_dim_names=axes)


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: 16x16 chips a pod, two pods for
    the multi-pod layout."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16x16 ("data", "model") or 2x16x16 ("pod", "data", "model") over a
    world of 256 or 512 ranks."""
    shape, axes = production_mesh_shape(multi_pod)
    return make_compat_mesh(shape, axes, device_type)


def make_host_mesh(n_devices: int | None = None, model: int = 1,
                   device_type: str | None = None):
    """(n // model, model) ("data", "model") over the world's ranks; with no
    process group up, a (1, 1) mesh over a world of 1 formed here
    (`core.distributed.process_group`: torchrun's environment, else a
    `file://` store)."""
    if not dist.is_initialized():
        from repro_torch.core.distributed import process_group

        process_group(None, "cuda" if device_type == "cuda" else "cpu")
    n = n_devices or world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into a model axis of {model}")
    return make_compat_mesh((n // model, model), ("data", "model"), device_type)


def submesh(mesh, names):
    """The sub-mesh of `mesh` over the axes `names`, flattened to one dim
    when there are several. Made outside any `FakeTensorMode` (the mesh's
    rank table is a real tensor, which the dry run's fake mode refuses)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    names = tuple(names)
    with unset_fake_temporarily():
        sub = mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()
    return sub


def ambient_mesh():
    """The mesh installed by `set_mesh_compat`, or None."""
    return getattr(_AMBIENT, "mesh", None)


@contextlib.contextmanager
def set_mesh_compat(mesh):
    """Install `mesh` as the ambient mesh for the block (None clears it)."""
    prev = ambient_mesh()
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev
