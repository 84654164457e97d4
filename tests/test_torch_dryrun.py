"""The dry run's op counting (`launch.analysis`) and cells
(`launch.dryrun`) on the CPU, on fake worlds.

  * a product counts exactly its 2 M N K; a Python loop of n products
    counts n of them; a loop counted one trip `scaled` n times counts the
    same as the loop, and serving's blockwise attention run for one trip
    of its loops (`sample_loops`) counts what the whole run counts;
  * a DTensor product counts what one rank does, not the global product;
  * each collective kind's wire bytes are `repro`'s ring formulas, held
    against `repro.launch.analysis.analyze_hlo` on the same collective
    written as HLO;
  * the roofline terms and bottleneck, and `Roofline.to_dict`'s keys,
    `repro`'s;
  * `model_step_flops` equal to `repro`'s for every arch and shape;
  * two fake-world cells, gemma-2b train_4k on 16x16 and mamba2-130m
    long_500k on 2x16x16, `status: ok` with `useful_flop_ratio` in (0, 1].
"""

import json

import pytest
import torch
import torch.distributed as dist

from repro_torch import device as dev
from repro_torch.launch import analysis as ta
from repro_torch.launch.shapes import SHAPE_ORDER, SHAPES
from repro_torch.models.registry import get_model, list_archs

torch.set_num_threads(1)


@pytest.fixture
def fake_world():
    from repro_torch.launch.dryrun import fake_world as make

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _count(fn, sample_loops=False):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        counter = ta.StepCounter(sample_loops=sample_loops)
        with counter:
            fn()
    return counter.costs


def test_products_count_exactly_and_loops_count_each_trip():
    def one():
        torch.zeros(64, 128) @ torch.zeros(128, 32)

    def loop():
        a, b = torch.zeros(64, 128), torch.zeros(128, 32)
        for _ in range(5):
            a @ b

    c = _count(one)
    assert c.flops == 2 * 64 * 128 * 32 and c.flops_by_op == {"mm": 2 * 64 * 128 * 32}
    assert c.bytes_by_op["mm"] == (64 * 128 + 128 * 32 + 64 * 32) * 4  # operands + result
    assert _count(loop).flops == 5 * 2 * 64 * 128 * 32

    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a, b = torch.zeros(64, 128), torch.zeros(128, 32)
        counter = ta.StepCounter()
        with counter:
            with counter.scaled(5):
                a @ b
    assert counter.costs.flops == 5 * 2 * 64 * 128 * 32


@pytest.mark.parametrize("window", [None, 700])
def test_sampled_blockwise_attention_counts_the_whole_loop(window):
    from repro_torch.models import common as cm

    def run():
        q = torch.zeros(2, 2048, 4, 64, dtype=torch.bfloat16)
        k = torch.zeros(2, 2048, 2, 64, dtype=torch.bfloat16)
        with torch.no_grad():
            out = cm.blockwise_attention(q, k, k, window=window)
        assert out.shape == q.shape

    full, sampled = _count(run), _count(run, sample_loops=True)
    assert sampled.flops == full.flops and sampled.bytes_accessed == full.bytes_accessed
    assert abs(sampled.peak_bytes - full.peak_bytes) <= 0.1 * full.peak_bytes
    assert cm.blockwise_attention.__module__ == cm.__name__  # the plain one, back in place


def test_a_dtensor_product_counts_one_rank(fake_world):
    from torch.distributed.tensor import Replicate, Shard, zeros

    from repro_torch.launch.mesh import make_compat_mesh

    fake_world(256)
    mesh = make_compat_mesh((16, 16), ("data", "model"), "cpu")

    def run():
        x = zeros((64, 2048), dtype=torch.bfloat16, device_mesh=mesh,
                  placements=(Shard(0), Replicate()))
        w = zeros((2048, 16384), dtype=torch.bfloat16, device_mesh=mesh,
                  placements=(Replicate(), Shard(1)))
        x @ w

    assert _count(run).flops == 2 * 64 * 2048 * 16384 / 256


HLO = """HloModule m

ENTRY %main (p0: f32[1024]) -> f32[1024] {{
  %p0 = f32[1024] parameter(0)
  ROOT %c = {result} {op}(%p0), replica_groups=[32,8]<=[256]
}}
"""


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter", "all-reduce", "all-to-all"])
def test_collective_wire_bytes_are_repros(kind, fake_world):
    import torch.distributed._functional_collectives as funcol

    from repro.launch.analysis import analyze_hlo

    fake_world(8)
    group = dist.group.WORLD

    def run():
        x = torch.zeros(1024)
        out = {"all-gather": lambda: funcol.all_gather_tensor(x, 0, group),
               "reduce-scatter": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
               "all-reduce": lambda: funcol.all_reduce(x, "sum", group),
               "all-to-all": lambda: funcol.all_to_all_single(x, None, None, group)}[kind]()
        funcol.wait_tensor(out)

    c = _count(run)
    n = {"all-gather": 8192, "reduce-scatter": 128}.get(kind, 1024)
    want = analyze_hlo(HLO.format(result=f"f32[{n}]", op=kind))
    assert c.collective_counts == {kind: 1}
    assert c.collective_wire[kind] == pytest.approx(want.collective_wire[kind], rel=1e-12)
    assert c.collective_operand[kind] == pytest.approx(want.collective_operand[kind], rel=1e-12)


def test_roofline_terms_bottleneck_and_keys():
    from repro.launch.analysis import Roofline as JRoofline

    kw = dict(flops=2e15, bytes_accessed=5e12, collective_wire=2e11, collective_operand=2e11,
              collective_detail={"all-reduce": 1e11}, n_devices=256, model_flops=3e17,
              raw_cost_analysis={"flops": 2e15})
    r = ta.Roofline(**kw)
    assert r.t_compute == 2e15 / dev.BF16_OPS_PER_S
    assert r.t_memory == 5e12 / dev.HBM_BYTES_PER_S
    assert r.t_collective == 2e11 / dev.LINK_BYTES_PER_S
    assert r.bottleneck == "collective" and r.t_bound == r.t_collective
    assert r.useful_flop_ratio == 3e17 / (2e15 * 256)
    assert r.mfu_bound == 3e17 / (r.t_bound * 256 * dev.BF16_OPS_PER_S)
    assert set(r.to_dict()) == set(JRoofline(**kw).to_dict())
    assert ta.Roofline(**dict(kw, collective_wire=0.0)).bottleneck == "compute"
    assert ta.Roofline(**dict(kw, flops=1.0, collective_wire=0.0)).bottleneck == "memory"


def test_model_step_flops_match_repro():
    from repro.launch import shapes as jshapes
    from repro.launch.analysis import model_step_flops as jflops
    from repro.models.registry import get_model as jget_model

    for arch in list_archs():
        for name in SHAPE_ORDER:
            assert ta.model_step_flops(get_model(arch), SHAPES[name]) == jflops(
                jget_model(arch), jshapes.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch,shape,multi_pod", [("gemma-2b", "train_4k", False),
                                                   ("mamba2-130m", "long_500k", True)])
def test_fake_world_cells_are_ok(arch, shape, multi_pod, fake_world, tmp_path):
    from repro_torch.launch import dryrun

    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "multi" if multi_pod else "single",
                 "--out", str(tmp_path)])
    [path] = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert 0 < rec["roofline"]["useful_flop_ratio"] <= 1
    assert rec["memory"]["peak_hbm_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["collective_wire_bytes"] > 0
    assert rec["param_count"] == get_model(arch).param_count()
