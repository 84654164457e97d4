"""The port's device wave loop against its host loop and against `repro`.

Mirrors tests/test_wave_loop.py at its sizes (batch 1024, chunk 128, 12
days, target 20, max_runs 10): for the same seed and config the device loop
(segments of gated waves compacted into a device accept buffer, one host
sync a segment) gives the host loop's accepted set bitwise, the same rows
in the same order, with the same runs and simulations; for every
registered model of the port, under a schedule, at R=12, across budget
exhaustion and across checkpoint/resume. On the CPU both loops run the
plain version, and the device loop is the same torch code as on the card.
`compact_accepted`, `wave_capacity` and `_auto_device_loop` are held to
`repro`'s on shared inputs.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abc as jabc
from repro_torch.core import abc as tabc
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model, list_models
from repro_torch.epi.spec import InterventionSchedule, regionalize
from repro_torch.kernels import ref
from repro_torch.launch import abc_run

torch.set_num_threads(1)

DAYS = 12


def _spec(model):
    if model == "metapop_seir_r12":
        return regionalize(get_model("metapop_seir"), 12, "ring:0.1")
    return get_model(model.replace("_scheduled", ""))


def _schedule(model):
    if model.endswith("_scheduled"):
        return InterventionSchedule.inferred(("alpha0",), (5,), 0.2, 1.5)
    return None


def _cfg(spec, tol, **kw):
    base = dict(batch_size=1024, tolerance=tol, target_accepted=20, chunk_size=128,
                strategy="outfeed", max_runs=10, num_days=DAYS, model=spec)
    base.update(kw)
    return tabc.ABCConfig(**base)


def _model_tolerance(spec, schedule=None, quantile=0.02) -> float:
    """epsilon at a ~2% pilot acceptance rate for `spec` (models have very
    different distance scales)."""
    ds = get_dataset("synthetic_small", num_days=DAYS, model=spec)
    cfg = _cfg(spec, 1.0, chunk_size=1024, schedule=schedule)
    return tabc.calibrate_tolerance(ds, cfg, seed=99, quantile=quantile, n_pilot=1024,
                                    device="cpu")


def _both(ds, cfg, seed=0, **kw):
    host = tabc.run_abc(ds, dataclasses.replace(cfg, wave_loop="host"), seed=seed,
                        device="cpu", **kw)
    dev = tabc.run_abc(ds, dataclasses.replace(cfg, wave_loop="device"), seed=seed,
                       device="cpu", **kw)
    return host, dev


def _assert_identical(host, dev):
    assert len(dev) == len(host) > 0
    assert (dev.runs, dev.simulations) == (host.runs, host.simulations)
    np.testing.assert_array_equal(host.theta, dev.theta)
    np.testing.assert_array_equal(host.distances, dev.distances)


@pytest.mark.parametrize("model", list(list_models()) + ["siard_scheduled", "metapop_seir_r12"])
def test_device_loop_identical_to_host_loop(model):
    spec, schedule = _spec(model), _schedule(model)
    ds = get_dataset("synthetic_small", num_days=DAYS, model=spec)
    cfg = _cfg(spec, _model_tolerance(spec, schedule), schedule=schedule)
    host, dev = _both(ds, cfg)
    _assert_identical(host, dev)
    if schedule is not None:
        assert dev.param_names[-1] == "alpha0_w1"
    if spec.is_regional:
        assert spec.n_regions in (4, 12)


def test_device_loop_budget_exhaustion_identical():
    """With an unreachable target both loops burn the same wave budget and
    keep every accepted sample."""
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = _cfg(spec, _model_tolerance(spec), target_accepted=10**6, max_runs=4)
    host, dev = _both(ds, cfg, seed=3)
    assert host.runs == dev.runs == 4
    _assert_identical(host, dev)


def test_device_loop_checkpoint_resume_identical(tmp_path):
    """Segmented (checkpointing) and interrupted-then-resumed device runs
    reproduce the uninterrupted accepted set, and so does a device run
    resumed from a host-loop checkpoint."""
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = _cfg(spec, _model_tolerance(spec), target_accepted=40, max_runs=20,
               wave_loop="device")
    full = tabc.run_abc(ds, cfg, seed=7, device="cpu")
    path = str(tmp_path / "wave_state.npz")
    seg = tabc.run_abc(ds, cfg, seed=7, checkpoint_every=2, checkpoint_path=path, device="cpu")
    _assert_identical(full, seg)
    for first in ("device", "host"):
        st = tabc.ABCState()
        tabc.run_abc(ds, dataclasses.replace(cfg, max_runs=2, wave_loop=first), seed=7,
                     state=st, checkpoint_every=1, checkpoint_path=path, device="cpu")
        resumed = tabc.ABCState.load(path)
        assert resumed.run_idx == st.run_idx == 2
        _assert_identical(full, tabc.run_abc(ds, cfg, seed=7, state=resumed, device="cpu"))


def test_device_loop_saves_at_the_host_loops_checkpoints(tmp_path, monkeypatch):
    """A segment ends at each multiple of checkpoint_every, where the host
    loop saves, and the state is saved after every segment."""
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = _cfg(spec, 0.0, target_accepted=10**6, max_runs=7, wave_loop="device")
    saved = []
    monkeypatch.setattr(tabc.ABCState, "save", lambda self, path: saved.append(self.run_idx))
    monkeypatch.setattr(tabc, "SEGMENT_WAVES", 4)
    tabc.run_abc(ds, cfg, seed=1, checkpoint_every=3, checkpoint_path="unused", device="cpu")
    assert saved == [3, 6, 7]


def test_segments_and_host_syncs(monkeypatch):
    """One host sync a segment, and the accepted set does not depend on the
    segment's length."""
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = _cfg(spec, _model_tolerance(spec, quantile=0.005), target_accepted=60,
               wave_loop="device")
    syncs = tabc.HOST_SYNCS
    whole = tabc.run_abc(ds, cfg, seed=2, device="cpu")
    assert tabc.HOST_SYNCS - syncs == 1 and whole.runs <= tabc.SEGMENT_WAVES
    monkeypatch.setattr(tabc, "SEGMENT_WAVES", 3)
    syncs = tabc.HOST_SYNCS
    short = tabc.run_abc(ds, cfg, seed=2, device="cpu")
    assert tabc.HOST_SYNCS - syncs == -(-whole.runs // 3)
    _assert_identical(whole, short)


def test_device_loop_never_harvests_on_the_host(monkeypatch):
    """The device loop does not call the host loop's `_harvest`, and gated
    waves do not call the plain version: one call a wave that ran."""
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = _cfg(spec, _model_tolerance(spec), wave_loop="device")

    def no_harvest(*args):
        raise AssertionError("_harvest called by the device loop")

    monkeypatch.setattr(tabc, "_harvest", no_harvest)
    calls = ref.CALLS
    post = tabc.run_abc(ds, cfg, seed=0, device="cpu")
    assert ref.CALLS - calls == post.runs < tabc.SEGMENT_WAVES


def test_auto_mode_picks_device_for_outfeed():
    assert tabc._auto_device_loop(tabc.ABCConfig(strategy="outfeed", chunk_size=10_000))
    assert not tabc._auto_device_loop(tabc.ABCConfig(strategy="topk"))
    assert not tabc._auto_device_loop(tabc.ABCConfig(chunk_size=10_000, wave_loop="host"))
    big = tabc.ABCConfig(chunk_size=10_000, target_accepted=10**9)
    assert not tabc._auto_device_loop(big)
    assert tabc._auto_device_loop(dataclasses.replace(big, wave_loop="device"))


#: (batch_size, target_accepted, strategy, wave_loop); topk with the device
#: loop is refused by both (test_topk_with_the_device_loop_raises_as_repro)
GRID = [c for c in itertools.product((1024, 100_000, 2_000_000),
                                     (1, 100, 10**6, 3_999_000, 10**9),
                                     ("outfeed", "topk"), ("auto", "host", "device"))
        if c[2:] != ("topk", "device")]


@pytest.mark.parametrize("batch,target,strategy,wave_loop", GRID)
def test_wave_capacity_and_auto_mode_equal_repro(batch, target, strategy, wave_loop):
    kw = dict(batch_size=batch, target_accepted=target, strategy=strategy,
              chunk_size=batch, wave_loop=wave_loop)
    mine, theirs = tabc.ABCConfig(**kw), jabc.ABCConfig(**kw)
    assert tabc.wave_capacity(mine) == jabc.wave_capacity(theirs)
    assert tabc.wave_capacity(mine, 77) == jabc.wave_capacity(theirs, 77)
    assert tabc._auto_device_loop(mine) == jabc._auto_device_loop(theirs)


def test_topk_with_the_device_loop_raises_as_repro():
    with pytest.raises(ValueError) as theirs:
        jabc.ABCConfig(strategy="topk", wave_loop="device")
    with pytest.raises(ValueError) as mine:
        tabc.ABCConfig(strategy="topk", wave_loop="device")
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown wave_loop 'sideways'"):
        tabc.ABCConfig(chunk_size=10_000, wave_loop="sideways")


def test_a_tolerance_that_is_no_float32_number_gives_one_set():
    """The tolerance just below an accepted distance v, in float64, rounds
    to v in float32: both loops accept v, as their float32 comparisons do."""
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    sim = tabc.make_simulator(ds, _cfg(spec, 1.0), "cpu")
    _, d = sim.wave(spec.prior(), *tabc.wave_seeds(4, 0), 1024)
    v = np.float32(np.sort(d.numpy())[25])
    tol = float(v) - float(np.spacing(v)) / 4
    assert tol < float(v) and tabc.tolerance32(tol) == float(v)
    host, dev = _both(ds, _cfg(spec, tol, target_accepted=20, max_runs=1), seed=4)
    _assert_identical(host, dev)
    assert v in host.distances


# ------------------------------------------------------------------------
# The runner at the capacity edge (tests/test_wave_loop.py:124, :222, :245)
# ------------------------------------------------------------------------

def _runner(cfg, capacity=None, days=DAYS):
    ds = get_dataset("synthetic_small", num_days=days)
    prior = get_model("siard").prior()
    runner = tabc.make_wave_runner(prior, tabc.make_simulator(ds, cfg, "cpu"), cfg)
    if capacity is not None:
        runner = dataclasses.replace(runner, capacity=capacity)
    return runner, runner.init(tabc.ABCState(n_params=prior.dim))


def test_wave_capacity_never_overflows():
    """Entering a wave needs accepted < target, and a wave adds at most one
    batch: with eps = inf one wave overshoots to a full batch."""
    cfg = tabc.ABCConfig(batch_size=512, target_accepted=10, tolerance=np.inf,
                         chunk_size=512, num_days=DAYS, max_runs=3)
    runner, carry = _runner(cfg)
    out = runner(0, 0, carry, 3)
    waves, n, fill = runner.read(out)
    assert (n, waves, fill) == (512, 1, 512) and fill <= tabc.wave_capacity(cfg)
    assert out.enqueued == 3
    assert out.theta_buf.shape == (tabc.wave_capacity(cfg) + 1, 8)


def test_wave_loop_single_wave_overflow_reports_clamped_fill():
    """A capacity-capped loop whose one wave over-accepts clamps its fill to
    the capacity, while the accepted count counts every acceptance."""
    B = 256
    cfg = tabc.ABCConfig(batch_size=B, tolerance=np.inf, target_accepted=10**6,
                         chunk_size=B, num_days=15, max_runs=2)
    runner, carry = _runner(cfg, capacity=B // 2, days=15)
    out = runner(0, 0, carry, 1)
    waves, n, fill = runner.read(out)
    assert (waves, n, fill) == (1, B, B // 2)
    assert bool(torch.isfinite(out.dist_buf[:fill]).all())


def test_wave_capacity_reaches_exactly_full():
    """target == capacity: the loop stops when the buffer is exactly full,
    every row valid."""
    B = 128
    cfg = tabc.ABCConfig(batch_size=B, tolerance=np.inf, target_accepted=2 * B,
                         chunk_size=B, num_days=15, max_runs=4)
    runner, carry = _runner(cfg, capacity=2 * B, days=15)
    out = runner(0, 0, carry, 4)
    assert runner.read(out) == (2, 2 * B, 2 * B)
    assert bool(torch.isfinite(out.dist_buf[:2 * B]).all())


# ------------------------------------------------------------------------
# compact_accepted bitwise repro's (tests/test_wave_loop.py:164-220)
# ------------------------------------------------------------------------

CASES = {
    # capacity, batch, fill, accept, dist
    "zero_accepts": (8, 4, 3, [False] * 4, np.arange(4.0)),
    "fills_capacity_exactly": (6, 4, 2, [True] * 4, [10.0, 11.0, 12.0, 13.0]),
    "overflow_drops_excess": (4, 6, 2, [True, False, True, True, True, False],
                              np.arange(10.0, 16.0)),
}


@pytest.mark.parametrize("case", CASES)
def test_compact_accepted_equals_repro(case):
    cap, B, fill, accept, dist = CASES[case]
    p = 2
    th_buf = np.full((cap, p), -1.0, np.float32)
    d_buf = np.full((cap,), np.inf, np.float32)
    theta = np.arange(B * p, dtype=np.float32).reshape(B, p)
    dist = np.asarray(dist, np.float32)
    accept = np.asarray(accept)
    j_th, j_d, j_fill = jabc.compact_accepted(jnp.asarray(th_buf), jnp.asarray(d_buf),
                                              jnp.int32(fill), jnp.asarray(theta),
                                              jnp.asarray(dist), jnp.asarray(accept), cap)
    # the port's buffers carry the spare row at index `cap`
    t_th = torch.from_numpy(np.concatenate([th_buf, np.full((1, p), -1.0, np.float32)]))
    t_d = torch.from_numpy(np.concatenate([d_buf, [np.inf]]).astype(np.float32))
    t_th, t_d, t_fill = tabc.compact_accepted(
        t_th, t_d, torch.tensor([fill]), torch.from_numpy(theta), torch.from_numpy(dist),
        torch.from_numpy(accept), cap)
    assert t_th.shape == (cap + 1, p)
    np.testing.assert_array_equal(t_th[:cap].numpy().view(np.uint32),
                                  np.asarray(j_th).view(np.uint32))
    np.testing.assert_array_equal(t_d[:cap].numpy().view(np.uint32),
                                  np.asarray(j_d).view(np.uint32))
    assert int(t_fill) == int(j_fill) == fill + int(accept.sum())


# ------------------------------------------------------------------------
# The gate of the simulator on the CPU, and the CLI
# ------------------------------------------------------------------------

def test_a_gate_of_zero_skips_the_plain_version():
    spec = get_model("siard")
    ds = get_dataset("synthetic_small", num_days=DAYS)
    sim = tabc.make_simulator(ds, _cfg(spec, 1.0), "cpu")
    prior = spec.prior()
    theta = torch.full((64, 8), 7.5)
    dist = torch.full((64,), -3.25)
    calls = ref.CALLS
    got = sim.wave(prior, 1, 2, 64, gate=torch.zeros((1,), dtype=torch.int32),
                   out=(theta, dist))
    assert ref.CALLS == calls and got[0] is theta and got[1] is dist
    assert bool((theta == 7.5).all() and (dist == -3.25).all())
    sim(prior.sample(1, 64), 2, gate=torch.zeros((1,), dtype=torch.int32))
    assert ref.CALLS == calls
    th1, d1 = sim.wave(prior, 1, 2, 64, gate=torch.ones((1,), dtype=torch.int32),
                       out=(theta, dist))
    th2, d2 = sim.wave(prior, 1, 2, 64)
    assert ref.CALLS == calls + 2
    assert torch.equal(th1, th2) and torch.equal(d1, d2)
    assert torch.equal(sim(th2, 2, gate=torch.ones((1,), dtype=torch.int32)), sim(th2, 2))
    for bad in (torch.zeros((1,), dtype=torch.int64), torch.zeros((2,), dtype=torch.int32),
                0):
        with pytest.raises(ValueError, match="gate must be an int32 tensor"):
            sim.wave(prior, 1, 2, 64, gate=bad)
    with pytest.raises(ValueError, match="out's theta"):
        sim.wave(prior, 1, 2, 64, out=(torch.empty((64, 7)), dist))


def test_cli_wave_loop_flag(capsys):
    argv = ["--device", "cpu", "--dataset", "synthetic_small", "--days", "10", "--batch",
            "1024", "--chunk", "256", "--auto-tolerance", "0.05", "--accept", "10",
            "--max-runs", "5"]
    host = abc_run.main(argv + ["--wave-loop", "host"])
    dev = abc_run.main(argv + ["--wave-loop", "device"])
    auto = abc_run.main(argv)
    assert "(device wave loop)" in capsys.readouterr().out
    _assert_identical(host, dev)
    _assert_identical(host, auto)
    with pytest.raises(SystemExit):
        abc_run.main(argv + ["--wave-loop", "sideways"])
    with pytest.raises(ValueError, match="outfeed harvest semantics"):
        abc_run.main(argv + ["--wave-loop", "device", "--strategy", "topk"])
