"""The port's scaling study and its lockstep reference
(`repro_torch.core.scaling`), in one process on the CPU.

Mirrors tests/test_scaling.py at its sizes (`_CFG_KW`: 2048 x 12 days,
target 60, six waves): the N-shard reference runs the sharded program in
one process (tests/test_torch_distributed.py holds N gloo ranks to it
bitwise); one shard is today's `WaveRunner` bit for bit; N = 4 and 8
harvest through `run_abc`; a state resumes across 4 -> 2 -> 1 shards split
as `repro`'s `WaveRunner.init` splits it, and a `repro` checkpoint resumes
sharded; `ScalingConfig` refuses what `repro`'s refuses; a one-count study
has `repro`'s report keys and cell fields.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import abc as jabc
from repro.core.scaling import ScalingConfig as JaxScalingConfig
from repro.core.scaling import run_scaling_study as jax_run_scaling_study
from repro_torch.core import abc as tabc
from repro_torch.core import distributed
from repro_torch.core.scaling import (
    ScalingConfig,
    device_mesh,
    format_report,
    make_reference_wave_runner,
    run_scaling_study,
)
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model

torch.set_num_threads(1)

DAYS = 12
#: tests/test_scaling.py's config on the port's backend
_CFG_KW = dict(batch_size=2048, tolerance=3.4e3, target_accepted=60, chunk_size=2048,
               max_runs=6, num_days=DAYS, wave_loop="device")
#: `repro`'s ScalingConfig fields the port drops (JAX-only knobs) and adds
JAX_ONLY = {"tile", "scan_unroll"}
PORT_ONLY = {"block"}


def _setup(**kw):
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**{**_CFG_KW, **kw})
    prior = get_model("siard").prior()
    return ds, cfg, prior, tabc.make_simulator(ds, cfg, "cpu")


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _rows(theta):
    return {r.tobytes() for r in _bits(theta)}


def test_one_shard_reference_is_todays_wave_runner():
    ds, cfg, prior, sim = _setup()
    ref = make_reference_wave_runner(prior, sim, cfg, n_shards=1)
    today = tabc.make_wave_runner(prior, sim, cfg)
    assert ref == today and ref.shards == 1
    outs = [r(0, 0, r.init(tabc.ABCState(n_params=8)), cfg.max_runs) for r in (ref, today)]
    assert ref.read(outs[0]) == today.read(outs[1])
    for a, b in zip(ref.segments(outs[0]), today.segments(outs[1])):
        np.testing.assert_array_equal(a, b)
    solo = tabc.run_abc(ds, cfg, seed=0, device="cpu")
    post = tabc.run_abc(ds, cfg, seed=0, wave_runner=ref)
    np.testing.assert_array_equal(_bits(post.theta), _bits(solo.theta))
    np.testing.assert_array_equal(_bits(post.distances), _bits(solo.distances))
    assert (post.runs, post.simulations) == (solo.runs, solo.simulations)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_reference_runner_multi_shard_harvests_through_run_abc(n_shards):
    """Multi-shard buffers harvest into a posterior holding every shard's
    rows in shard order, each shard with its own seeds."""
    ds, cfg, prior, sim = _setup()
    ref = make_reference_wave_runner(prior, sim, cfg, n_shards=n_shards)
    assert ref.capacity == tabc.wave_capacity(cfg, 2048 // n_shards) == jabc.wave_capacity(
        jabc.ABCConfig(**{**_CFG_KW, "backend": "xla_fused"}), 2048 // n_shards)
    post = tabc.run_abc(ds, cfg, seed=0, wave_runner=ref)
    assert len(post) >= cfg.target_accepted
    assert np.isfinite(post.distances).all() and (post.distances <= cfg.tolerance).all()
    assert post.simulations == post.runs * cfg.batch_size
    out = ref(0, 0, ref.init(tabc.ABCState(n_params=8)), cfg.max_runs)
    waves, n, fills = ref.read(out)
    assert (waves, n) == (post.runs, len(post)) and len(fills) == n_shards
    theta, _, f = ref.segments(out)
    cap = ref.capacity
    in_order = np.concatenate([theta[s * cap:s * cap + c] for s, c in enumerate(f)])
    np.testing.assert_array_equal(_bits(in_order), _bits(post.theta))
    # shard 0 draws the unsharded wave's first B/n rows, shard 1 rows of its own
    full, _ = sim.wave(prior, *tabc.wave_seeds(0, 0), 2048)
    th0, _ = sim.wave(prior, *tabc.shard_seeds(0, 0, 0), 2048 // n_shards)
    th1, _ = sim.wave(prior, *tabc.shard_seeds(0, 0, 1), 2048 // n_shards)
    assert torch.equal(th0, full[:2048 // n_shards]) and not torch.equal(th0, th1)


def test_reference_runner_rejects_uneven_shards():
    _, cfg, prior, sim = _setup(batch_size=2047, chunk_size=2047)
    with pytest.raises(ValueError, match="not divisible"):
        make_reference_wave_runner(prior, sim, cfg, n_shards=4)


def _repro_split(state_arrays, shards, capacity):
    """`repro`'s `WaveRunner.init` of these rows: its buffers and fills."""
    theta, dist = state_arrays
    st = jabc.ABCState(accepted_theta=[theta] if len(theta) else [],
                       accepted_dist=[dist] if len(dist) else [], n_params=8)
    jr = jabc.WaveRunner(fn=None, capacity=capacity, shards=shards, n_params=8,
                         cfg=jabc.ABCConfig(**{**_CFG_KW, "backend": "xla_fused"}))
    th_buf, d_buf, n0, fills = jr.init(st)
    return np.asarray(th_buf), np.asarray(d_buf), np.atleast_1d(np.asarray(fills)), int(n0)


def _assert_split_is_repros(runner, state):
    carry = runner.init(state)
    cap = runner.capacity
    th_buf, d_buf, fills, n0 = _repro_split(state.to_arrays(), runner.shards, cap)
    for s in range(runner.shards):
        np.testing.assert_array_equal(_bits(carry[0][s][:cap].numpy()),
                                      _bits(th_buf[s * cap:(s + 1) * cap]))
        np.testing.assert_array_equal(_bits(carry[1][s][:cap].numpy()),
                                      _bits(d_buf[s * cap:(s + 1) * cap]))
        assert int(carry[2][s]) == fills[s]
    assert int(carry[3]) == n0 == state.n_accepted


def test_state_resumes_across_four_two_one_shards(tmp_path):
    """A state left by 4 shards resumes on 2, then on 1: each init splits the
    rows as `repro`'s does, no accepted row is lost, and the run goes on
    from its run index to the target."""
    ds, cfg, prior, sim = _setup()
    path = str(tmp_path / "state.npz")
    state = tabc.ABCState()
    tabc.run_abc(ds, dataclasses.replace(cfg, max_runs=2), seed=0, state=state,
                 wave_runner=make_reference_wave_runner(prior, sim, cfg, 4),
                 checkpoint_every=1, checkpoint_path=path)
    kept = _rows(state.to_arrays()[0])
    assert state.run_idx == 2 and 0 < len(kept) < cfg.target_accepted
    for shards, max_runs in ((2, 3), (1, 60)):
        state = tabc.ABCState.load(path)
        runner = make_reference_wave_runner(prior, sim, cfg, shards)
        _assert_split_is_repros(runner, state)
        run_idx0 = state.run_idx
        assert state.n_accepted < cfg.target_accepted
        post = tabc.run_abc(ds, dataclasses.replace(cfg, max_runs=max_runs), seed=0,
                            state=state, wave_runner=runner, checkpoint_every=1,
                            checkpoint_path=path)
        assert kept <= _rows(post.theta)
        assert post.runs > run_idx0 and post.simulations == post.runs * cfg.batch_size
        kept = _rows(post.theta)
    assert len(post) >= cfg.target_accepted


def test_repro_checkpoint_resumes_sharded(tmp_path):
    """An `ABCState` written by `repro` resumes on 4 shards of the port."""
    _, cfg, prior, sim = _setup()
    g = np.random.default_rng(3)
    lo, hi = np.asarray(prior.lows), np.asarray(prior.highs)
    theta = (lo + (hi - lo) * g.random((23, 8))).astype(np.float32)
    dist = np.sort(g.random(23) * cfg.tolerance).astype(np.float32)
    path = str(tmp_path / "repro_state.npz")
    jabc.ABCState(run_idx=3, simulations=3 * 2048, accepted_theta=[theta],
                  accepted_dist=[dist], n_params=8).save(path)
    state = tabc.ABCState.load(path)
    runner = make_reference_wave_runner(prior, sim, cfg, 4)
    _assert_split_is_repros(runner, state)
    ds = get_dataset("synthetic_small", num_days=DAYS)
    post = tabc.run_abc(ds, dataclasses.replace(cfg, max_runs=60), seed=0, state=state,
                        wave_runner=runner)
    assert _rows(theta) <= _rows(post.theta)
    assert post.runs > 3 and post.simulations == post.runs * 2048
    assert len(post) >= cfg.target_accepted


def test_scaling_config_validation():
    with pytest.raises(ValueError, match="non-empty"):
        ScalingConfig(device_counts=())
    with pytest.raises(ValueError, match="style"):
        ScalingConfig(style="magic")
    with pytest.raises(ValueError, match="unknown backends"):
        ScalingConfig(backends=("xla_fused",))
    jax_fields = {f.name for f in dataclasses.fields(JaxScalingConfig)}
    port_fields = {f.name for f in dataclasses.fields(ScalingConfig)}
    assert port_fields == (jax_fields - JAX_ONLY) | PORT_ONLY
    mine, theirs = ScalingConfig(), JaxScalingConfig()
    for name in port_fields - PORT_ONLY - {"backends"}:
        assert getattr(mine, name) == getattr(theirs, name), name


def test_device_mesh_prefix_subsets_and_overflow():
    with distributed.world("cpu") as group:
        assert device_mesh(1) is group
        assert distributed.data_axes(group) == (0,)
        with pytest.raises(ValueError, match="torchrun --nproc-per-node=2"):
            device_mesh(2)
    assert not torch.distributed.is_initialized()


def test_one_count_study_has_repros_report():
    """The smallest device count is the efficiency reference: efficiency 1,
    overhead 0, the fixed simulation budget; the report's keys and each
    cell's fields are `repro`'s (its study run in this process on the same
    tiny config, as tests/test_scaling.py:151 runs it)."""
    kw = dict(device_counts=(1,), models=("sir",), batch_per_device=512, waves=2,
              num_days=DAYS, reps=1)
    theirs = jax_run_scaling_study(JaxScalingConfig(**kw))
    with distributed.world("cpu"):
        rep = run_scaling_study(ScalingConfig(**kw), device="cpu")
    assert set(rep) == set(theirs)
    assert set(rep["config"]) == (set(theirs["config"]) - JAX_ONLY) | PORT_ONLY
    assert list(rep["cells"]) == ["sir/cuda/b512/n1"]
    assert list(theirs["cells"]) == ["sir/xla_fused/b512/n1"]
    cell, their_cell = rep["cells"]["sir/cuda/b512/n1"], theirs["cells"]["sir/xla_fused/b512/n1"]
    assert set(cell) == set(their_cell)
    assert cell["parallel_efficiency"] == 1.0 and cell["scaling_overhead_pct"] == 0.0
    assert cell["simulations"] == their_cell["simulations"] == 2 * 512
    assert (cell["waves"], cell["devices"], cell["global_batch"]) == (2, 1, 512)
    assert cell["sims_per_s"] > 0 and 0 < cell["accept_rate"] < 1
    assert (rep["n_visible_devices"], rep["device_kind"], rep["reference_device_count"]) == (
        1, "cpu", 1)
    table = format_report(rep)
    assert "overhead_%" in table and "sir" in table
    json.dumps(rep, allow_nan=False)


@pytest.mark.parametrize("argv,message", [
    (["--scaling", "--regions", "4"], "--regions/--mobility are not supported with --scaling"),
    (["--scaling", "--backend", "npe"], "not a campaign/scaling grid axis"),
    (["--scaling", "--backends", "npe"], "invalid choice"),
    (["--multi-device", "--backend", "npe"], "--multi-device has no effect with --backend npe"),
    (["--scaling-devices", "2"], "--scaling-devices has no effect without --scaling"),
    (["--scaling-waves", "2"], "--scaling-waves has no effect without --scaling"),
    (["--scaling-reps", "1"], "--scaling-reps has no effect without --scaling"),
    (["--scaling-out", "s.json"], "--scaling-out has no effect without --scaling"),
])
def test_cli_refuses_what_repro_refuses(argv, message, capsys):
    from repro_torch.launch import abc_run

    with pytest.raises(SystemExit):
        abc_run.main(["--device", "cpu"] + argv)
    assert message in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_cli_multi_device_world_of_one_is_the_single_run():
    """`abc_run --multi-device` without torchrun forms a world of 1 and
    gives the single-device posterior on both sharded loops."""
    from repro_torch.launch import abc_run

    base = ["--device", "cpu", "--dataset", "synthetic_small", "--days", "10", "--batch",
            "1024", "--chunk", "256", "--auto-tolerance", "0.05", "--accept", "10",
            "--max-runs", "5"]
    solo = abc_run.main(base + ["--wave-loop", "device"])
    for loop in ("device", "host"):
        post = abc_run.main(base + ["--wave-loop", loop, "--multi-device"])
        np.testing.assert_array_equal(_bits(post.theta), _bits(solo.theta))
        assert (post.runs, post.simulations) == (solo.runs, solo.simulations)
    assert not torch.distributed.is_initialized()
