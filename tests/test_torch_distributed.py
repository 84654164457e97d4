"""Scale-out over gloo ranks on the CPU (`repro_torch.core.distributed`).

Each test spawns its ranks with `distributed.spawn_ranks` (processes of this
host joined by a `file://` store under tmp_path, each with a join timeout of
its own, so a hung rank fails its test) at tests/test_scaling.py's sizes
(`_CFG_KW`, 2048 x 12 days):

  * 8 ranks of `make_wave_runner` bitwise the 8-shard lockstep reference
    (tests/test_scaling.py:60), and a world of 1 bitwise the unsharded run;
  * the host-loop runner's global count equal to the host's filter count
    (tests/test_smc_distributed.py:42), its chunks each rank's shard;
  * accept rates of 1 and 4 ranks within `repro`'s bar
    (tests/test_smc_distributed.py:87);
  * one shard overflowing while the others stay empty
    (tests/test_distributed_edges.py:57), uneven batches refused;
  * the sharded SMC round (tests/test_scaling.py:193);
  * `abc_run --scaling` over 2 ranks; unknown styles refused by both
    makers, and the pjit style's own refusals (an uneven batch, a chunk
    that does not divide B/n); tests/test_torch_pjit.py holds that style.

The ranks import neither `jax` nor `repro`; neither does this file.
"""

import contextlib
import dataclasses
import hashlib
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import abc as tabc
from repro_torch.core import distributed
from repro_torch.core.scaling import make_reference_wave_runner
from repro_torch.core.smc import SMCConfig, make_sharded_smc_round_fn, run_smc_abc
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model
from repro_torch.launch import abc_run

torch.set_num_threads(1)

DAYS = 12
_CFG_KW = dict(batch_size=2048, tolerance=3.4e3, target_accepted=60, chunk_size=2048,
               max_runs=6, num_days=DAYS, wave_loop="device")
#: a rank's join timeout, seconds
TIMEOUT = 120


def _digest(runner, out):
    """sha256 of the gathered segments, fills, total and waves (`repro`'s
    digest of tests/test_scaling.py, on the port's layout)."""
    waves, n, _ = runner.read(out)
    h = hashlib.sha256()
    for a in runner.segments(out):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.int64(n).tobytes())
    h.update(np.int64(waves).tobytes())
    return h.hexdigest(), n, waves


def _wave_runner_rank(rank, world):
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    wr = distributed.make_wave_runner(None, ds, cfg, device="cpu")
    assert (wr.shards, wr.shard) == (world, rank)
    out = wr(0, 0, wr.init(tabc.ABCState(n_params=8)), cfg.max_runs)
    return _digest(wr, out)


def test_eight_ranks_bitwise_the_eight_shard_reference(tmp_path):
    """The acceptance criterion: 8 gloo ranks and the 8-shard program in one
    process give the same segments, fills, totals and wave counts."""
    got = distributed.spawn_ranks(_wave_runner_rank, 8, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    ref = make_reference_wave_runner(get_model("siard").prior(),
                                     tabc.make_simulator(ds, cfg, "cpu"), cfg, 8)
    want = _digest(ref, ref(0, 0, ref.init(tabc.ABCState(n_params=8)), cfg.max_runs))
    assert want[1] > 0
    assert got == [want] * 8


def test_world_of_one_is_the_unsharded_run():
    """Shard 0 keeps the unsharded seeds: a world of 1 over gloo is `run_abc`
    bit for bit, with one host sync a segment and the same segments as
    today's runner."""
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    solo = tabc.run_abc(ds, cfg, seed=0, device="cpu")
    with distributed.world("cpu") as group:
        assert dist.get_backend(group) == "gloo"
        wr = distributed.make_wave_runner(group, ds, cfg, device="cpu")
        syncs = tabc.HOST_SYNCS
        post = tabc.run_abc(ds, cfg, seed=0, wave_runner=wr)
        assert tabc.HOST_SYNCS - syncs == -(-post.runs // tabc.SEGMENT_WAVES)
        out = wr(0, 0, wr.init(tabc.ABCState(n_params=8)), cfg.max_runs)
        today = tabc.make_wave_runner(get_model("siard").prior(),
                                      tabc.make_simulator(ds, cfg, "cpu"), cfg)
        want = today(0, 0, today.init(tabc.ABCState(n_params=8)), cfg.max_runs)
        for a, b in zip(wr.segments(out), today.segments(want)):
            np.testing.assert_array_equal(a, b)
    assert not dist.is_initialized()
    np.testing.assert_array_equal(post.theta, solo.theta)
    np.testing.assert_array_equal(post.distances, solo.distances)
    assert (post.runs, post.simulations) == (solo.runs, solo.simulations)


#: epsilon near the 0.3% quantile of the port's series at 15 days, so that
#: some 128-sample chunks hold an accept and others none (the partially
#: accepting wave of tests/test_distributed_edges.py:101)
_HOST_KW = dict(batch_size=8 * 512, tolerance=5.0e3, target_accepted=10**9,
                chunk_size=128, strategy="outfeed", num_days=15, max_runs=1)


def _host_runner_rank(rank, world):
    ds = get_dataset("synthetic_small", num_days=15)
    cfg = tabc.ABCConfig(**_HOST_KW)
    runner = distributed.make_runner(None, ds, cfg, device="cpu")
    out = runner(*tabc.wave_seeds(0, 0))
    again = runner(*tabc.wave_seeds(0, 0))
    assert torch.equal(again.dist, out.dist) and torch.equal(again.theta, out.theta)
    return (out.theta.numpy(), out.dist.numpy(),
            distributed.effective_chunk_flags(out).numpy(), int(out.accept_count))


def test_host_loop_runner_global_count_equals_host_filter(tmp_path):
    """8 ranks of the host-loop runner: the global count equals the host's
    filter count of the gathered chunks, the flags mark exactly the chunks
    with an accept, every rank holds the same output, rank r's chunks are
    shard r's wave, and a repeated call gives the same bits."""
    got = distributed.spawn_ranks(_host_runner_rank, 8, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    theta, d, flags, count = got[0]
    assert d.shape == (8 * 512 // 128, 128) and theta.shape == (32, 128, 8)
    assert count == int((d <= _HOST_KW["tolerance"]).sum()) > 0
    np.testing.assert_array_equal(flags, (d <= _HOST_KW["tolerance"]).any(axis=1))
    assert 0 < flags.sum() < flags.size
    for other in got[1:]:
        for a, b in zip(other[:3], got[0][:3]):
            np.testing.assert_array_equal(a, b)
        assert other[3] == count
    ds = get_dataset("synthetic_small", num_days=15)
    cfg = tabc.ABCConfig(**_HOST_KW)
    sim, prior = tabc.make_simulator(ds, cfg, "cpu"), get_model("siard").prior()
    for r in range(8):
        th_r, d_r = sim.wave(prior, *tabc.shard_seeds(0, 0, r), 512)
        np.testing.assert_array_equal(theta[4 * r:4 * r + 4].reshape(512, 8), th_r.numpy())
        np.testing.assert_array_equal(d[4 * r:4 * r + 4].reshape(512), d_r.numpy())


def _rate_rank(rank, world):
    ds = get_dataset("synthetic_small", num_days=15)
    cfg = tabc.ABCConfig(batch_size=world * 2048, tolerance=1.8e4, target_accepted=10**9,
                         chunk_size=256, num_days=15, max_runs=1)
    runner = distributed.make_runner(None, ds, cfg, device="cpu")
    total = sum(int(runner(*tabc.wave_seeds(1, r)).accept_count) for r in range(4))
    return total / (4 * cfg.batch_size)


def test_accept_rate_independent_of_rank_count(tmp_path):
    """The accept rate does not depend on the rank count (`repro`'s bar)."""
    rates = {n: distributed.spawn_ranks(_rate_rank, n, device="cpu", timeout=TIMEOUT,
                                        tmp_dir=str(tmp_path))
             for n in (1, 4)}
    assert len(set(rates[4])) == 1
    r1, r4 = rates[1][0], rates[4][0]
    assert r1 > 0
    assert abs(r1 - r4) / r1 < 0.8, rates


class _OnlyShardZeroAccepts:
    """A simulator whose shard 0 accepts every row and whose other shards
    accept none; it writes nothing under a closed gate."""

    device = torch.device("cpu")

    def __init__(self, shard):
        self.shard = shard

    def wave(self, prior, prior_seed, sim_seed, batch, gate=None, out=None):
        theta, dist_ = out
        if gate is not None and int(gate[0]) == 0:
            return out
        theta.fill_(0.5)
        dist_.fill_(0.0 if self.shard == 0 else float("inf"))
        return out

    def record_gated(self, entry, batch, n):
        """Nothing launched on the CPU, as `AbcSim.record_gated` there."""


def _overflow_rank(rank, world):
    prior = get_model("siard").prior()
    local_b = 64
    cfg = tabc.ABCConfig(batch_size=world * local_b, tolerance=1.0, target_accepted=10**6,
                         chunk_size=world * local_b, max_runs=3, num_days=10,
                         wave_loop="device")
    runner = distributed.ShardedWaveRunner(
        sim=_OnlyShardZeroAccepts(rank), prior=prior, cfg=cfg, capacity=local_b,
        n_params=8, group=dist.group.WORLD, shard=rank, n_shards=world)
    out = runner(0, 0, runner.init(tabc.ABCState(n_params=8)), 3)
    waves, n, fills = runner.read(out)
    theta, d, f = runner.segments(out)
    # an uneven global batch is refused by every sharded maker
    uneven = dataclasses.replace(cfg, batch_size=1023, chunk_size=1023)
    refused = []
    for maker in (distributed.make_shardmap_runner, distributed.make_shardmap_wave_runner):
        with pytest.raises(ValueError, match="not divisible"):
            maker(dist.group.WORLD, prior, _OnlyShardZeroAccepts(rank), uneven)
        refused.append(maker.__name__)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_smc_round_fn(dist.group.WORLD, _OnlyShardZeroAccepts(rank), prior,
                                  SMCConfig(batch_size=1023, num_days=10, wave_loop="device"))
    return waves, n, fills, d, f, refused


def test_one_shard_overflows_while_others_stay_empty(tmp_path):
    """Only shard 0 accepts: its fill clamps to its capacity, the other
    segments stay untouched, and the global count counts every accept."""
    got = distributed.spawn_ranks(_overflow_rank, 4, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    for waves, n, fills, d, f, refused in got:
        assert (waves, n, fills) == (3, 3 * 64, (64, 0, 0, 0))
        np.testing.assert_array_equal(f, [64, 0, 0, 0])
        assert np.isfinite(d[:64]).all() and np.isinf(d[64:]).all()
        assert refused == ["make_shardmap_runner", "make_shardmap_wave_runner"]


_SMC_KW = dict(n_particles=48, batch_size=1024, n_rounds=2, num_days=DAYS, wave_loop="device")


def _smc_rank(rank, world):
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = SMCConfig(**_SMC_KW)
    a = run_smc_abc(ds, cfg, seed=0, device="cpu", group=dist.group.WORLD)
    b = run_smc_abc(ds, cfg, seed=0, device="cpu", group=dist.group.WORLD)
    np.testing.assert_array_equal(a.theta, b.theta)
    return a.theta, a.distances, a.tolerance, a.round_waves


def test_sharded_smc_round(tmp_path):
    """SMC rounds over 4 ranks: a full population of finite particles, the
    same on every rank, deterministic in (seed, world size), tightening the
    tolerance as the single round does; a world of 1 is the single round;
    the host loop with a group is refused."""
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = SMCConfig(**_SMC_KW)
    single = run_smc_abc(ds, cfg, seed=0, device="cpu")
    got = distributed.spawn_ranks(_smc_rank, 4, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    theta, d, tol, _ = got[0]
    assert theta.shape == (48, 8) and np.isfinite(d).all()
    for other in got[1:]:
        np.testing.assert_array_equal(other[0], theta)
    assert tol <= 1.5 * single.tolerance
    assert not np.array_equal(theta, single.theta)  # four ranks' streams
    with distributed.world("cpu") as group:
        one = run_smc_abc(ds, cfg, seed=0, device="cpu", group=group)
        with pytest.raises(ValueError, match="wave_loop"):
            run_smc_abc(ds, SMCConfig(wave_loop="host"), seed=0, device="cpu", group=group)
    np.testing.assert_array_equal(one.theta, single.theta)
    assert one.round_waves == single.round_waves


def _scaling_cli_rank(rank, world, out_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = abc_run.main([
            "--scaling", "--device", "cpu", "--models", "sir", "--batch", "256",
            "--days", str(DAYS), "--scaling-devices", "1", "2", "--scaling-waves", "2",
            "--scaling-reps", "1", "--scaling-out", out_path])
    return report, buf.getvalue()


def test_scaling_cli_over_two_ranks(tmp_path):
    """`abc_run --scaling` on 2 gloo ranks: weak-scaling budgets a cell,
    rank 0 alone prints and writes the report."""
    out_path = str(tmp_path / "scaling.json")
    got = distributed.spawn_ranks(_scaling_cli_rank, 2, out_path, device="cpu",
                                  timeout=TIMEOUT, tmp_dir=str(tmp_path))
    (report, text), (other, other_text) = got
    assert other is None and other_text == ""
    assert "overhead_%" in text and "[scaling] report saved" in text
    assert json.loads(open(out_path).read()) == json.loads(json.dumps(report))
    for n in (1, 2):
        cell = report["cells"][f"sir/cuda/b256/n{n}"]
        assert cell["simulations"] == 2 * 256 * n and cell["waves"] == 2
        assert 0 < cell["parallel_efficiency"] and cell["global_batch"] == 256 * n
    assert report["n_visible_devices"] == 2


def _pjit_refusal_rank(rank, world):
    """The pjit makers on 2 ranks: what each refuses, by its message."""
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    prior, sim = get_model("siard").prior(), tabc.make_simulator(ds, cfg, "cpu")
    refused = []
    for kw in (dict(batch_size=1023, chunk_size=1023), dict(chunk_size=2048)):
        bad = dataclasses.replace(cfg, **kw)
        for maker in (distributed.make_pjit_runner, distributed.make_pjit_wave_runner):
            try:
                maker(dist.group.WORLD, prior, sim, bad)
            except ValueError as e:
                refused.append((maker.__name__, str(e)))
    wr = distributed.make_wave_runner(None, ds, cfg, style="pjit", device="cpu")
    return refused, type(wr).__name__


def test_unknown_styles_and_pjit_uneven_shapes_refused(tmp_path):
    """Both makers refuse an unknown style, before they form a group. On 2
    ranks the pjit style is accepted, and refuses what cannot be one
    logical wave: an uneven batch (both runners), and a chunk that does not
    divide a rank's B/n rows (the host loop; the device loop has no
    chunks)."""
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    for maker in (distributed.make_wave_runner, distributed.make_runner):
        with pytest.raises(ValueError, match="unknown runner style"):
            maker(None, ds, cfg, style="magic", device="cpu")
    assert not dist.is_initialized()
    got = distributed.spawn_ranks(_pjit_refusal_rank, 2, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    for refused, runner in got:
        assert runner == "PjitWaveRunner"
        assert [(name, msg.split(" (")[0]) for name, msg in refused] == [
            ("make_pjit_runner", "batch_size 1023 not divisible by 2 devices"),
            ("make_pjit_wave_runner", "batch_size 1023 not divisible by 2 devices"),
            ("make_pjit_runner", "chunk_size 2048 does not divide the 1024 rows of a rank")]
