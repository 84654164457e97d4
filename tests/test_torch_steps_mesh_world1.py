"""The meshed train step on a world of 1, a (1, 1) mesh, against the
single-device step: two steps (the second from the first's parameters and
moments), with and without microbatches, bit for bit in every loss, global
norm, parameter and moment. Every redistribution and collective is then a
no-op, so any difference is an op the meshed path runs otherwise: the two
found were the vocab-parallel cross entropy taken on a vocab "split" over
a mesh dim of 1 (its logsumexp spelled out, whose backward rounds
otherwise) and a reduce-scatter handing back a transposed shard, over which
the global norm's sum adds in another order (`steps._row_major`).

deepseek-moe-16b is not bit for bit there: the gradient of its MoE input
is the bf16 sum of three parts (router, routed experts, shared experts),
which autograd adds in another order when the routed experts run on local
tensors; tests/test_torch_steps_mesh.py's bars hold it.

The rank worker is a module-level function (spawn imports this file in
the child; it imports no `jax`).
"""

import pytest
import torch

from repro_torch.core.distributed import spawn_ranks

torch.set_num_threads(1)

SHAPE = ("t", "train", 32, 4)


def _rank_two_steps(rank, n, arch, microbatch):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step, full_tree, shard_tree
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    mesh = make_host_mesh()
    model = get_model(arch, smoke=True)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for which, m in (("single", None), ("mesh", mesh)):
        params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
        opt = adamw_init(params)
        built = build_train_step(model, InputShape(*SHAPE), m, opt_cfg=cfg,
                                 microbatch=microbatch)
        if m is not None:
            params = shard_tree(params, built.in_shardings[0])
            opt = shard_tree(opt, built.in_shardings[1])
        metrics = []
        for step in range(2):
            batch = model.example_inputs("train", SHAPE[3], SHAPE[2], "cpu", seed=1 + step)
            if m is not None:
                batch = shard_tree(batch, built.in_shardings[2])
            params, opt, met = built.fn(params, opt, batch)
            metrics.append({k: float(v.full_tensor() if m is not None else v)
                            for k, v in met.items()})
        state = (params, opt) if m is None else full_tree((params, opt))
        out[which] = (metrics, [t.clone() for t in tree_leaves(state)])
    return out


@pytest.mark.parametrize("arch,microbatch", [
    ("gemma-2b", 1), ("gemma-2b", 2), ("gemma2-27b", 1), ("mamba2-130m", 2),
    ("qwen3-moe-30b-a3b", 1), ("zamba2-2.7b", 1)])
def test_world_of_one_mesh_step_is_the_single_device_step(arch, microbatch, tmp_path):
    (got,) = spawn_ranks(_rank_two_steps, 1, arch, microbatch, device="cpu", timeout=180,
                         tmp_dir=str(tmp_path))
    (m_single, single), (m_mesh, meshed) = got["single"], got["mesh"]
    assert m_mesh == m_single
    assert len(meshed) == len(single)
    differ = [i for i, (a, b) in enumerate(zip(meshed, single)) if not torch.equal(a, b)]
    assert not differ, f"{arch}: {len(differ)} of {len(single)} leaves differ: {differ[:10]}"
