"""Scale-out in the pjit style on the CPU (`repro_torch.core.distributed`,
`make_pjit_runner` / `make_pjit_wave_runner`).

In this style rank r of n draws rows [r·B/n, (r+1)·B/n) of the one logical
wave, with the wave's own seeds at sample offset r·B/n, so n ranks give
the single-device run bit for bit (tests/test_wave_loop.py:140-150 holds
`repro`'s GSPMD runner to its single-device stream the same way):

  * the sample offset of the plain versions: `prior.sample(seed, b,
    offset=o)` and `abc_sim_distance_ref(..., sample_offset=o)` are bitwise
    rows [o, o + b) of the offset-0 draw of o + b, for SIARD, SIARD under a
    schedule and metapop_seir (R=4); offsets that leave the 32-bit index
    are refused;
  * the device loop over 1, 2 and 4 gloo ranks (spawned by
    `distributed.spawn_ranks`, at tests/test_torch_distributed.py's sizes,
    2048 x 12 days) bitwise the unsharded `run_abc`, for SIARD and for
    metapop_seir; a state crossing between pjit and unsharded runs;
  * the host loop over 2 ranks (tests/test_smc_distributed.py:42-83): the
    outfeed `RunOutput` bitwise `abc_run_batch`'s, the global count equal
    to the host's filter count, topk the single-device k rows, an uneven
    batch and a chunk that does not divide B/n refused;
  * the scaling study in this style over 2 ranks;
  * `repro`'s pjit runner against its own single-device run, and the
    port's against `repro`'s by the accept rate, the statistic of
    tests/test_torch_distributed.py (threefry and the counter hash draw
    different samples).

The rank workers are module-level functions (spawn imports this file in
each child); only `test_against_repro` imports `repro`, inside itself.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import abc as tabc
from repro_torch.core import distributed
from repro_torch.core.priors import schedule_prior
from repro_torch.core.scaling import ScalingConfig, run_scaling_study
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule, regionalize
from repro_torch.kernels import abc_sim, ref
from repro_torch.kernels import rng as krng

torch.set_num_threads(1)

DAYS = 12
_CFG_KW = dict(batch_size=2048, tolerance=3.4e3, target_accepted=60, chunk_size=2048,
               max_runs=6, num_days=DAYS, wave_loop="device")
#: metapop_seir's tolerance: about 2% of its prior predictive at 12 days
_METAPOP_QUANTILE = 0.02
#: a rank's join timeout, seconds
TIMEOUT = 120


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _same_posterior(got, want):
    assert len(want) > 0
    _same(got.theta, want.theta)
    _same(got.distances, want.distances)
    assert (got.runs, got.simulations) == (want.runs, want.simulations)


# --------------------------------------------------------------------------
# The offset of the plain versions
# --------------------------------------------------------------------------

def _case(name):
    """(spec, schedule) of an offset case."""
    if name == "siard_scheduled":
        return get_model("siard"), InterventionSchedule.inferred(("alpha0",), (5,), 0.2, 1.5)
    return get_model(name), None


@pytest.mark.parametrize("offset", [1, 37, 4096])
@pytest.mark.parametrize("name", ["siard", "siard_scheduled", "metapop_seir"])
def test_plain_versions_at_an_offset_are_the_tail(name, offset):
    """theta and distances at offset o are rows [o, o + b) of offset 0."""
    spec, sched = _case(name)
    prior = schedule_prior(spec, sched)
    ds = get_dataset("synthetic_small", num_days=DAYS, model=spec)
    b = 24
    full = prior.sample(11, offset + b)
    tail = prior.sample(11, b, offset=offset)
    _same(tail, full[offset:])
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0, model=spec,
              schedule=sched)
    obs = torch.as_tensor(ds.observed)
    lead = min(3, offset)  # a launch that starts a few rows earlier
    d_full = ref.abc_sim_distance_ref(full[offset - lead:], 5, obs, **kw,
                                      sample_offset=offset - lead)
    d_tail = ref.abc_sim_distance_ref(tail, 5, obs, **kw, sample_offset=offset)
    _same(d_tail, d_full[lead:])
    if offset == 37:  # offset 0 is the default: the whole batch from index 0
        _same(ref.abc_sim_distance_ref(full, 5, obs, **kw)[offset:],
              ref.abc_sim_distance_ref(full[offset:], 5, obs, **kw, sample_offset=offset))


@pytest.mark.parametrize("name", ["siard", "metapop_seir"])
def test_simulator_wave_at_an_offset_on_the_cpu(name):
    """`AbcSim.wave(..., offset=o)` on the CPU is the tail of the wave of
    o + b, theta and distances (NaN as +inf), into `out` as well."""
    spec = get_model(name)
    ds = get_dataset("synthetic_small", num_days=DAYS, model=spec)
    cfg = tabc.ABCConfig(batch_size=64, chunk_size=64, num_days=DAYS, model=spec)
    sim, prior = tabc.make_simulator(ds, cfg, "cpu"), spec.prior()
    th_full, d_full = sim.wave(prior, 3, 4, 64)
    out = (torch.empty((40, prior.dim)), torch.empty((40,)))
    th, d = sim.wave(prior, 3, 4, 40, out=out, offset=24)
    assert th is out[0] and d is out[1]
    _same(th, th_full[24:])
    _same(d, d_full[24:])


def test_offsets_past_the_32_bit_index_are_refused():
    prior = get_model("siard").prior()
    assert krng.check_offset(2**32 - 5, 5) == 2**32 - 5
    tail = prior.sample(0, 2, offset=2**32 - 2)  # the last two indices
    lo, hi = (torch.tensor(v, dtype=torch.float32) for v in (prior.lows, prior.highs))
    u = krng.uniform_open(0, torch.tensor([[2**32 - 2], [2**32 - 1]]), torch.arange(8)[None, :])
    _same(tail, lo + u * (hi - lo))
    ds = get_dataset("synthetic_small", num_days=DAYS)
    sim = tabc.make_simulator(ds, tabc.ABCConfig(batch_size=8, chunk_size=8,
                                                 num_days=DAYS), "cpu")
    for call in (lambda: prior.sample(0, 6, offset=2**32 - 5),
                 lambda: prior.sample(0, 1, offset=-1),
                 lambda: krng.sample_indices(2, offset=2**32 - 1),
                 lambda: sim.wave(prior, 0, 0, 8, offset=2**32 - 7),
                 lambda: ref.abc_sim_distance_ref(tail, 0, torch.as_tensor(ds.observed),
                                                  population=ds.population, a0=ds.a0,
                                                  r0=ds.r0, d0=ds.d0, sample_offset=2**32 - 1)):
        with pytest.raises(ValueError, match="32-bit sample index"):
            call()


def test_shards_of_a_regional_wave_may_take_the_other_route():
    """Why chip_smoke.py's phase scaleout_path (j) runs metapop_seir at
    R=20 on 2 ranks: a rank's 50,000 rows take the warp route, the
    single-device 100,000 the thread route; the pjit run is only its
    single-device run because both routes are bitwise equal."""
    spec = regionalize(get_model("metapop_seir"), 20, "ring:0.1")
    assert abc_sim.regional_route(spec, 100_000) == "thread"
    assert abc_sim.regional_route(spec, 50_000) == "warp"


# --------------------------------------------------------------------------
# The device loop
# --------------------------------------------------------------------------

def _metapop_cfg():
    spec = get_model("metapop_seir")
    ds = get_dataset("synthetic_small", num_days=DAYS, model=spec)
    cal = tabc.ABCConfig(batch_size=1024, chunk_size=1024, num_days=DAYS, model=spec)
    tol = tabc.calibrate_tolerance(ds, cal, seed=99, quantile=_METAPOP_QUANTILE,
                                   n_pilot=1024, device="cpu")
    return ds, tabc.ABCConfig(batch_size=512, chunk_size=512, tolerance=tol,
                              target_accepted=30, max_runs=8, num_days=DAYS, model=spec,
                              wave_loop="device")


def _config(kind):
    if kind == "metapop_seir":
        return _metapop_cfg()
    return get_dataset("synthetic_small", num_days=DAYS), tabc.ABCConfig(**_CFG_KW)


def _pjit_rank(rank, world, kind):
    ds, cfg = _config(kind)
    wr = distributed.make_wave_runner(None, ds, cfg, style="pjit", device="cpu")
    assert (wr.shards, wr.n_shards, wr.shard, wr.capacity) == (
        1, world, rank, tabc.wave_capacity(cfg))
    syncs = tabc.HOST_SYNCS
    post = tabc.run_abc(ds, cfg, seed=0, wave_runner=wr)
    assert tabc.HOST_SYNCS - syncs == -(-post.runs // tabc.SEGMENT_WAVES)
    out = wr(0, 0, wr.init(tabc.ABCState(n_params=wr.n_params)), cfg.max_runs)
    with pytest.raises(RuntimeError, match="read"):
        wr.carry_of(out)
    read = wr.read(out)
    return post, read, wr.segments(out)


@pytest.mark.parametrize("kind,world", [("siard", 1), ("siard", 2), ("siard", 4),
                                        ("metapop_seir", 2)])
def test_device_loop_over_ranks_is_the_unsharded_run(tmp_path, kind, world):
    """n ranks of the pjit device loop: every rank's posterior, counts and
    single-device segment bitwise the unsharded `run_abc`'s, one host sync
    a segment."""
    ds, cfg = _config(kind)
    solo = tabc.run_abc(ds, cfg, seed=0, device="cpu")
    prior = schedule_prior(get_model(cfg.model), cfg.schedule)
    today = tabc.make_wave_runner(prior, tabc.make_simulator(ds, cfg, "cpu"), cfg)
    want_out = today(0, 0, today.init(tabc.ABCState(n_params=today.n_params)), cfg.max_runs)
    want_read, want_segments = today.read(want_out), today.segments(want_out)
    got = distributed.spawn_ranks(_pjit_rank, world, kind, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    assert solo.runs > 1 and len(solo) > world
    for post, read, segments in got:
        _same_posterior(post, solo)
        assert read == want_read
        for a, b in zip(segments, want_segments):
            np.testing.assert_array_equal(a, b)


def _resume_rank(rank, world, path, first_style):
    """One segment of two waves in `first_style` (rank 0 saves it), then the
    other style resumes it to the end."""
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    group = dist.group.WORLD
    first = dataclasses.replace(cfg, max_runs=2)
    pjit = distributed.make_wave_runner(group, ds, cfg, style="pjit", device="cpu")
    if first_style == "pjit":
        tabc.run_abc(ds, first, seed=0, wave_runner=pjit, checkpoint_every=2,
                     checkpoint_path=path)
    elif rank == 0:
        tabc.run_abc(ds, first, seed=0, device="cpu", checkpoint_every=2,
                     checkpoint_path=path)
    dist.barrier()
    state = tabc.ABCState.load(path)
    saved = (state.run_idx, state.n_accepted)
    if first_style == "pjit":
        return saved, tabc.run_abc(ds, cfg, seed=0, state=state, device="cpu")
    return saved, tabc.run_abc(ds, cfg, seed=0, state=state, wave_runner=pjit)


@pytest.mark.parametrize("first_style", ["pjit", "unsharded"])
def test_state_crosses_between_pjit_and_unsharded_runs(tmp_path, first_style):
    """A state checkpointed after one segment of 2 pjit ranks resumes
    unsharded, and one of an unsharded run resumes on 2 pjit ranks; either
    way the run ends bitwise the uninterrupted single run."""
    ds = get_dataset("synthetic_small", num_days=DAYS)
    cfg = tabc.ABCConfig(**_CFG_KW)
    solo = tabc.run_abc(ds, cfg, seed=0, device="cpu")
    got = distributed.spawn_ranks(_resume_rank, 2, str(tmp_path / "state.npz"), first_style,
                                  device="cpu", timeout=TIMEOUT, tmp_dir=str(tmp_path))
    assert solo.runs > 2
    for (run_idx, accepted), post in got:
        assert run_idx == 2 and 0 < accepted < len(solo)
        _same_posterior(post, solo)


# --------------------------------------------------------------------------
# The host loop
# --------------------------------------------------------------------------

#: tests/test_torch_distributed.py's host-loop config: some 128-sample
#: chunks hold an accept and others none
_HOST_KW = dict(batch_size=4 * 512, tolerance=5.0e3, target_accepted=10**9,
                chunk_size=128, strategy="outfeed", num_days=15, max_runs=1)
_TOPK_KW = dict(_HOST_KW, strategy="topk", top_k=5)


def _host_rank(rank, world):
    ds = get_dataset("synthetic_small", num_days=15)
    out = {}
    for name, kw in (("outfeed", _HOST_KW), ("topk", _TOPK_KW)):
        runner = distributed.make_runner(None, ds, tabc.ABCConfig(**kw), style="pjit",
                                         device="cpu")
        got = runner(*tabc.wave_seeds(0, 3))
        out[name] = (got.theta.numpy(), got.dist.numpy(), got.chunk_flags.numpy(),
                     int(got.accept_count))
    prior = get_model("siard").prior()
    sim = tabc.make_simulator(ds, tabc.ABCConfig(**_HOST_KW), "cpu")
    uneven = tabc.ABCConfig(**{**_HOST_KW, "batch_size": 1023, "chunk_size": 1023})
    big_chunk = tabc.ABCConfig(**{**_HOST_KW, "chunk_size": 2048})
    refused = []
    # the device loop has no chunks: only the host loop refuses big_chunk
    for maker, bad, match in ((distributed.make_pjit_runner, uneven, "not divisible"),
                              (distributed.make_pjit_wave_runner, uneven, "not divisible"),
                              (distributed.make_pjit_runner, big_chunk, "does not divide")):
        with pytest.raises(ValueError, match=match):
            maker(dist.group.WORLD, prior, sim, bad)
        refused.append((maker.__name__, match))
    return out, refused


def test_host_loop_over_two_ranks_is_abc_run_batch(tmp_path):
    """2 ranks of the pjit host loop: the outfeed chunks bitwise
    `abc_run_batch`'s, the global count the host's filter count, the flags
    the chunks with an accept, topk the single-device k rows; an uneven
    batch and a chunk that does not divide B/n refused."""
    got = distributed.spawn_ranks(_host_rank, 2, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    ds = get_dataset("synthetic_small", num_days=15)
    prior = get_model("siard").prior()
    for name, kw in (("outfeed", _HOST_KW), ("topk", _TOPK_KW)):
        cfg = tabc.ABCConfig(**kw)
        want = tabc.abc_run_batch(prior, tabc.make_simulator(ds, cfg, "cpu"), cfg,
                                  "cpu")(*tabc.wave_seeds(0, 3))
        _, d_all = tabc.make_simulator(ds, cfg, "cpu").wave(prior, *tabc.wave_seeds(0, 3),
                                                           cfg.batch_size)
        for out, _ in got:
            theta, d, flags, count = out[name]
            _same(theta, want.theta.numpy())
            _same(d, want.dist.numpy())
            np.testing.assert_array_equal(flags, want.chunk_flags.numpy())
            assert count == int((d_all <= cfg.tolerance).sum()) > 0
        if name == "outfeed":
            assert 0 < flags.sum() < flags.size
            assert count == int((d <= cfg.tolerance).sum())
        else:
            assert theta.shape == (5, 8) and np.all(np.diff(d) > 0)
    for _, refused in got:
        assert refused == [("make_pjit_runner", "not divisible"),
                           ("make_pjit_wave_runner", "not divisible"),
                           ("make_pjit_runner", "does not divide")]


# --------------------------------------------------------------------------
# The scaling study, and `repro`
# --------------------------------------------------------------------------

_SCFG_KW = dict(device_counts=(2,), models=("sir",), batch_per_device=256, waves=2,
                num_days=DAYS, reps=1, style="pjit")


def _study_rank(rank, world):
    return run_scaling_study(ScalingConfig(**_SCFG_KW), device="cpu")


def test_scaling_study_in_the_pjit_style(tmp_path):
    """`run_scaling_study(ScalingConfig(style="pjit"))` over 2 ranks: its
    cell accepts what the single-device run of the same global batch
    accepts, wave for wave."""
    got = distributed.spawn_ranks(_study_rank, 2, device="cpu", timeout=TIMEOUT,
                                  tmp_dir=str(tmp_path))
    report, other = got
    assert other is None and report["config"]["style"] == "pjit"
    cell = report["cells"]["sir/cuda/b256/n2"]
    assert (cell["simulations"], cell["waves"], cell["global_batch"]) == (2 * 512, 2, 512)
    cfg = tabc.ABCConfig(batch_size=512, chunk_size=512, tolerance=cell["tolerance"],
                         target_accepted=2 * 512 + 1, max_runs=2, num_days=DAYS, model="sir",
                         wave_loop="device")
    solo = tabc.run_abc(get_dataset("synthetic_small", num_days=DAYS, model="sir"), cfg,
                        seed=1, device="cpu")
    assert cell["n_accepted"] == len(solo) > 0


def test_against_repro():
    """`repro`'s pjit wave runner on one CPU device is its own single-device
    run (tests/test_wave_loop.py:140-150); the port's pjit run over 2 ranks
    accepts at `repro`'s rate within tests/test_torch_distributed.py's bar,
    on `repro`'s series."""
    import jax

    from repro.core import abc as jabc
    from repro.core.distributed import make_wave_runner as jax_make_wave_runner
    from repro.epi.data import get_dataset as jax_get_dataset
    from repro_torch import convert

    jds = jax_get_dataset("synthetic_small", num_days=DAYS)
    kw = dict(batch_size=2048, tolerance=3.4e3, target_accepted=400, chunk_size=2048,
              max_runs=4, num_days=DAYS, wave_loop="device")
    jcfg = jabc.ABCConfig(backend="xla_fused", **kw)
    # the GSPMD partitioner's own axes (jax's default mesh axes are explicit)
    mesh = jax.make_mesh((len(jax.devices()),), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jpost = jabc.run_abc(jds, jcfg, key=0,
                         wave_runner=jax_make_wave_runner(mesh, jds, jcfg, style="pjit"))
    jsolo = jabc.run_abc(jds, jcfg, key=0)
    np.testing.assert_array_equal(jpost.theta, jsolo.theta)
    tds = convert.country_data_from_arrays(jds.name, jds.population, jds.a0, jds.r0, jds.d0,
                                           np.asarray(jds.observed))
    cfg = tabc.ABCConfig(**kw)
    with distributed.world("cpu") as group:
        tpost = tabc.run_abc(tds, cfg, seed=0, wave_runner=distributed.make_wave_runner(
            group, tds, cfg, style="pjit", device="cpu"))
    r_jax, r_port = len(jpost) / jpost.simulations, len(tpost) / tpost.simulations
    assert r_jax > 0 and r_port > 0
    assert abs(r_port - r_jax) / r_jax < 0.8, (r_port, r_jax)
