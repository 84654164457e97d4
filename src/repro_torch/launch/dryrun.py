"""Multi-pod dry run: every (architecture x input shape x mesh) cell's step
on the production meshes, counted op by op on a fake world (port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single

Each cell runs in this one process on a fake world of 256 ranks (16x16,
"single") or 512 (2x16x16, "multi"): `torch.distributed`'s "fake" backend,
whose collectives do nothing, and `FakeTensorMode`, under which the
parameters, moments, batch and cache are DTensors of shapes and dtypes
with no storage. No device is touched and no parameter is allocated. The
step (`launch.steps.build_step` on the mesh) runs under
`launch.analysis.StepCounter`, which counts one rank's products, bytes,
collectives and peak live bytes; the record carries `repro`'s keys
(`memory.peak_hbm_bytes`, `roofline`, `param_count`, `active_param_count`,
`status`). They are counts on a fake world at the H100's ceilings, not
times measured on a card.

Results are written as JSON under experiments/dryrun_torch/ (one file a
cell, git-ignored); a cell that raises becomes `<cell>.fail.json` with its
reason. A host read of a value (`.item()`, `nonzero`, `bool(t)`) cannot run
under `FakeTensorMode`: a step that makes one fails its cell, named.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.ioutils import atomic_write_text
from repro_torch.launch.analysis import StepCounter, roofline_from_costs
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.launch.shapes import SHAPE_ORDER, SHAPES, applicable
from repro_torch.launch.steps import build_step
from repro_torch.models.decoder import TensorSpec
from repro_torch.models.registry import get_model, list_archs

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def fake_world(n: int) -> None:
    """A fake process group of n ranks in this process (rank 0), replacing
    any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _abstract(shape_tree, shardings):
    """DTensor zeros of each leaf's shape and dtype in its layout (under
    `FakeTensorMode`: no storage)."""
    from torch.distributed.tensor import zeros

    if isinstance(shape_tree, (torch.Tensor, TensorSpec)):
        return zeros(tuple(shape_tree.shape), dtype=shape_tree.dtype,
                     device_mesh=shardings.mesh, placements=shardings.placements)
    if isinstance(shape_tree, dict):
        return {k: _abstract(v, shardings[k]) for k, v in shape_tree.items()}
    return type(shape_tree)(_abstract(v, s) for v, s in zip(shape_tree, shardings))


def step_args(model, shape, built):
    """The step's abstract arguments, laid out as `built.in_shardings`."""
    params = model.param_shapes()
    if shape.mode == "train":
        p_sh, o_sh, b_sh = built.in_shardings
        opt = {"mu": _abstract(_f32(params), o_sh["mu"]),
               "nu": _abstract(_f32(params), o_sh["nu"]),
               "step": _abstract(TensorSpec((), torch.int32), o_sh["step"])}
        return (_abstract(params, p_sh), opt, _abstract(built.batch_shapes, b_sh))
    if shape.mode == "prefill":
        p_sh, b_sh = built.in_shardings
        return (_abstract(params, p_sh), _abstract(built.batch_shapes, b_sh))
    p_sh, c_sh, b_sh = built.in_shardings
    cache = model.init_cache_shape(shape.global_batch, shape.seq_len)
    return (_abstract(params, p_sh), _abstract(cache, c_sh),
            _abstract(built.batch_shapes, b_sh))


def _f32(tree):
    """The moments' shapes: each parameter's, float32."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), torch.float32)
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return type(tree)(_f32(v) for v in tree)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    return sum(t.to_local().numel() * t.to_local().element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, multi_pod: bool, rules_overrides=None,
             tag: str = "baseline", **step_kwargs) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape_, _ = production_mesh_shape(multi_pod)
    n_dev = 1
    for s in shape_:
        n_dev *= s
    fake_world(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    model = get_model(arch)
    shape = SHAPES[shape_name]
    if shape.mode != "train":
        step_kwargs.pop("microbatch", None)
    t0 = time.time()
    built = build_step(model, shape, mesh, rules_overrides=rules_overrides, **step_kwargs)
    with FakeTensorMode():
        args = step_args(model, shape, built)
        t_build = time.time() - t0
        counter = StepCounter(sample_loops=True)
        counter.track_inputs(args)
        with counter:
            out = built.fn(*args)
        c = counter.costs
        out_bytes = _local_bytes(out)
    t_run = time.time() - t0 - t_build
    # train donates its parameters and moments, decode its cache: written in place
    alias = {"train": _local_bytes(args[:2]), "decode": _local_bytes(args[1])}.get(
        shape.mode, 0)
    roof = roofline_from_costs(c, model, shape, n_dev)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "tag": tag,
        "mode": shape.mode,
        "n_devices": n_dev,
        "status": "ok",
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "ops": c.ops,
        "collective_counts": c.collective_counts,
        "memory": {
            "argument_bytes": c.argument_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": c.peak_bytes - c.argument_bytes,
            "alias_bytes": alias,
            "peak_hbm_bytes": c.peak_bytes,
        },
        "roofline": roof.to_dict(),
        "param_count": model.param_count(),
        "active_param_count": model.active_param_count(),
    }


def cell_path(arch, shape_name, multi_pod, tag="baseline") -> Path:
    mesh = "multi" if multi_pod else "single"
    return OUT_DIR / f"{arch}__{shape_name}__{mesh}__{tag}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--out", default=str(OUT_DIR), help="the records' directory")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    archs = list(list_archs()) if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_ORDER) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir.mkdir(parents=True, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        model = get_model(arch)
        for shape_name in shapes:
            if not applicable(model, shape_name):
                print(f"SKIP  {arch} x {shape_name} (long_500k needs sub-quadratic attention)")
                n_skip += 1
                continue
            for multi_pod in meshes:
                path = out_dir / cell_path(arch, shape_name, multi_pod, args.tag).name
                if path.exists() and not args.force:
                    print(f"CACHED {path.name}")
                    n_ok += 1
                    continue
                label = f"{arch} x {shape_name} x {'2x16x16' if multi_pod else '16x16'}"
                try:
                    rec = run_cell(arch, shape_name, multi_pod, tag=args.tag,
                                   microbatch=args.microbatch)
                    atomic_write_text(str(path), json.dumps(rec, indent=1))
                    path.with_suffix(".fail.json").unlink(missing_ok=True)  # an earlier try's
                    r = rec["roofline"]
                    print(f"OK    {label}: run={rec['compile_s']:.0f}s "
                          f"hbm/dev={rec['memory']['peak_hbm_bytes'] / 2**30:.2f}GiB "
                          f"t_comp={r['t_compute_s']:.2e} t_mem={r['t_memory_s']:.2e} "
                          f"t_coll={r['t_collective_s']:.2e} -> {r['bottleneck']}", flush=True)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001  (a failed cell is a record)
                    n_fail += 1
                    err = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "status": "fail", "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-3000:]}
                    atomic_write_text(str(path.with_suffix(".fail.json")),
                                      json.dumps(err, indent=1))
                    print(f"FAIL  {label}: {type(e).__name__}: {str(e)[:300]}", flush=True)
    print(f"\ndry-run complete: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
