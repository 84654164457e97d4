"""Elastic rescale in the port: a checkpoint written by one device restores
onto 8 gloo ranks laid out (2, 4) under the meshed train step's layouts
(reshard-on-load, `load_checkpoint(..., shardings=)`), as
tests/test_elastic.py does for `repro`. Each rank's blocks are the saved
leaves' bit for bit, and one step from the restored state gives the loss
and global norm of the same step on one device from the saved state (rtol
1e-3 and 1e-2, tests/test_torch_steps_mesh.py's bars).

The rank worker is a module-level function (spawn imports this file in
each child; it imports no `jax`).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import spawn_ranks

torch.set_num_threads(1)

ARCH = "gemma2-27b"
SHAPE = ("t", "train", 16, 8)


def _state(model):
    from repro_torch.launch.train import state_arrays
    from repro_torch.optim import adamw_init

    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params)
    # moments that are not all zero, so that their blocks are checked too
    for i, t in enumerate(opt["mu"]["layers"][0].values()):
        t.copy_(torch.linspace(-1, 1, t.numel()).reshape(t.shape) * (i + 1))
    opt["step"].fill_(5)
    return params, opt, state_arrays(params, opt)


def _rank_restore(rank, n, ckpt_dir):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _local_block
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step, shard_tree
    from repro_torch.launch.train import state_from_arrays, state_shardings
    from repro_torch.models.registry import get_model

    mesh = make_host_mesh(n, model=4)
    model = get_model(ARCH, smoke=True)
    built = build_train_step(model, InputShape(*SHAPE), mesh)
    params, opt, saved = _state(model)
    layouts = state_shardings(built.in_shardings)
    state, meta, step = Checkpointer(ckpt_dir).restore(saved, shardings=layouts)
    assert step == 5 and meta["arch"] == ARCH
    sharded = 0
    for key, dt in state.items():
        want = saved[key].numpy()
        assert tuple(dt.shape) == want.shape and tuple(dt.placements) == tuple(
            layouts[key].placements), key
        local = dt.to_local().numpy()
        np.testing.assert_array_equal(local, want[_local_block(want.shape, layouts[key])],
                                      err_msg=key)
        sharded += local.size < want.size
    params, opt = state_from_arrays(state, shard_tree(params, built.in_shardings[0]),
                                    shard_tree(opt, built.in_shardings[1]))
    batch = shard_tree(model.example_inputs("train", SHAPE[3], SHAPE[2], "cpu", seed=1),
                       built.in_shardings[2])
    _, opt, met = built.fn(params, opt, batch)
    return {"sharded": sharded, "leaves": len(state), "loss": float(met["loss"].full_tensor()),
            "grad_norm": float(met["grad_norm"].full_tensor()),
            "step": int(opt["step"].full_tensor())}


def test_one_device_checkpoint_restores_onto_2x4_and_trains(tmp_path):
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model

    model = get_model(ARCH, smoke=True)
    params, opt, saved = _state(model)
    save_checkpoint(tmp_path / "ck", 5, saved, metadata={"arch": ARCH})
    ranks = spawn_ranks(_rank_restore, 8, str(tmp_path / "ck"), device="cpu", timeout=180,
                        tmp_dir=str(tmp_path))
    assert all(r["leaves"] == len(saved) for r in ranks)
    assert all(r["sharded"] > 0 for r in ranks)  # every rank holds blocks, not copies
    assert all(np.isfinite(r["loss"]) and r["step"] == 6 for r in ranks)
    assert len({r["loss"] for r in ranks}) == 1
    _, opt, met = build_train_step(model, InputShape(*SHAPE), donate=False).fn(
        params, opt, model.example_inputs("train", SHAPE[3], SHAPE[2], "cpu", seed=1))
    assert int(opt["step"]) == 6
    np.testing.assert_allclose(ranks[0]["loss"], float(met["loss"]), rtol=1e-3)
    np.testing.assert_allclose(ranks[0]["grad_norm"], float(met["grad_norm"]), rtol=1e-2)


def test_reshard_on_load_refuses_a_missing_leaf(tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    save_checkpoint(tmp_path, 1, {"a": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(tmp_path, {"b": np.zeros(4, np.float32)}, shardings={"b": None})
