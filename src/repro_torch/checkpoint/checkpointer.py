"""Checkpoints of flat trees of tensors and arrays (port of
`repro.checkpoint.checkpointer`).

The on-disk layout is `repro`'s, so a checkpoint written by either package
loads in the other:

  * `<dir>/step_%010d/`, committed by renaming `step_%010d.tmp/` once every
    file is written: a crash mid-write never corrupts the latest step, and
    a leftover `.tmp` directory is never read;
  * `manifest.json` holds `step`, `time`, the caller's `metadata` and one
    entry a leaf (`path`, `file`, `shape`, `dtype`); a leaf's path is
    spelled as `jax.tree_util.keystr` spells a dict key, `"['name']"`, and
    the leaves are sorted by key, as JAX flattens a dict;
  * each leaf is its raw bytes as a flat uint8 `.npy`, rebuilt from the
    manifest's dtype and shape.

A tree is a flat `dict[str, torch.Tensor | np.ndarray]`. `Checkpointer`
keeps the newest `keep` steps; its `save_async` copies the tensors to host
numpy on the caller's thread and writes them on a writer thread, one write
in flight at a time, whose error comes back at the next `wait`.

Reshard-on-load, `repro`'s elastic path: given `shardings` (a dict like
`like` of layouts, anything with `.mesh` and `.placements`, such as
`launch.steps.Sharding`), each leaf is restored as a DTensor of that
layout, and each rank reads only its own block of the leaf's file (the
`.npy` is memory-mapped and sliced). A checkpoint written by one device
thereby restores onto N ranks under the step's layout.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ioutils import atomic_write


def _leaves(tree) -> List[Tuple[str, str, object]]:
    """(key, keystr path, leaf) of a flat dict, sorted by key."""
    if not isinstance(tree, dict) or not all(
            isinstance(k, str) and not isinstance(v, (dict, list, tuple))
            for k, v in tree.items()):
        raise TypeError(f"a checkpoint tree is a flat dict with str keys, got "
                        f"{type(tree).__name__}")
    return [(k, f"[{k!r}]", tree[k]) for k in sorted(tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_filename(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _steps(directory: Path) -> List[int]:
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if p.is_dir() and not p.name.endswith(".tmp"))


def save_checkpoint(directory: str | Path, step: int, tree: Dict,
                    metadata: Optional[Dict] = None) -> Path:
    """Synchronous atomic save. Returns the committed path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = directory / f"step_{step:010d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "metadata": metadata or {},
                "leaves": []}
    for i, (_, path, leaf) in enumerate(_leaves(tree)):
        arr = _to_numpy(leaf)
        shape = list(arr.shape)  # before ascontiguousarray (it promotes 0-d)
        arr = np.ascontiguousarray(arr)
        # analysis: allow(non-atomic-artifact-write) — the files land in the
        # uncommitted .tmp directory; the rename below is the commit
        np.save(tmp / _leaf_filename(i), arr.reshape(-1).view(np.uint8))
        manifest["leaves"].append({"path": path, "file": _leaf_filename(i),
                                   "shape": shape, "dtype": str(arr.dtype)})
    with atomic_write(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _local_block(shape, layout) -> Tuple[slice, ...]:
    """This rank's block of a tensor of `shape` laid out as `layout`: on
    each dim, the chunk its mesh coordinates pick (major to minor over the
    mesh dims that shard it, as DTensor lays it out)."""
    from torch.distributed.tensor import Shard

    mesh = layout.mesh
    coord = mesh.get_coordinate()
    block = []
    for d, n in enumerate(shape):
        k, parts = 0, 1
        for i, pl in enumerate(layout.placements):
            if isinstance(pl, Shard) and pl.dim == d:
                k, parts = k * mesh.size(i) + coord[i], parts * mesh.size(i)
        size = n // parts
        block.append(slice(k * size, (k + 1) * size))
    return tuple(block)


def _resharded(arr: np.ndarray, layout, device):
    """The DTensor of layout `layout` whose local block is this rank's
    block of `arr`."""
    from torch.distributed.tensor import DTensor

    local = torch.from_numpy(np.array(arr[_local_block(arr.shape, layout)]))
    return DTensor.from_local(local.to(device), layout.mesh, layout.placements,
                              run_check=False, shape=torch.Size(arr.shape),
                              stride=torch.empty(arr.shape, device="meta").stride())


def load_checkpoint(directory: str | Path, like: Dict, step: Optional[int] = None,
                    shardings: Optional[Dict] = None,
                    device="cpu") -> Tuple[Dict[str, object], Dict, int]:
    """Restore the leaves of `like` (the newest step unless `step` is
    given) as host numpy arrays, or, with `shardings`, as DTensors of those
    layouts on `device`, each rank holding its own block (reshard-on-load;
    the dtype is the file's). Returns (tree, metadata, step). A leaf
    missing from the checkpoint raises KeyError, one of another shape
    ValueError("shape mismatch ...")."""
    directory = Path(directory)
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    path = directory / f"step_{step:010d}"
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = {}
    for key, keypath, leaf_like in _leaves(like):
        e = by_path.get(keypath)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {keypath}")
        raw = np.load(path / e["file"], mmap_mode="r" if shardings is not None else None)
        arr = raw.view(np.dtype(e["dtype"])).reshape(e["shape"])
        expected = tuple(np.shape(leaf_like))
        if tuple(arr.shape) != expected:
            raise ValueError(f"shape mismatch for {keypath}: ckpt {arr.shape} vs {expected}")
        out[key] = arr if shardings is None else _resharded(arr, shardings[key], device)
    return out, manifest["metadata"], step


class Checkpointer:
    """Async keep-k checkpoint manager."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the write in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Dict, metadata: Optional[Dict] = None):
        """Copy to host memory now; write on a background thread."""
        self.wait()  # one in-flight save at a time
        # a copy of every host leaf, which the caller's next in-place update
        # (an optimizer step) cannot reach while the thread writes it
        host_tree = {k: _to_numpy(v) if isinstance(v, torch.Tensor) and v.device.type != "cpu"
                     else np.array(_to_numpy(v)) for k, v in tree.items()}

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, metadata)
                self._gc()
            except Exception as e:  # raised at the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Dict, metadata: Optional[Dict] = None):
        save_checkpoint(self.directory, step, tree, metadata)
        self._gc()

    def restore(self, like: Dict, step: Optional[int] = None,
                shardings: Optional[Dict] = None, device="cpu"):
        self.wait()
        return load_checkpoint(self.directory, like, step, shardings, device)

    def steps(self) -> List[int]:
        return _steps(self.directory)

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:010d}", ignore_errors=True)
