"""Intervention schedules in the port against `repro`'s.

Mirrors tests/test_interventions.py: the schedule spec and its prior, the
day-effective parameters, the plain version of the fused kernel under a
schedule against `repro`'s oracle, the no-window path bitwise the
constant-theta path (engine trajectories and the run_abc accepted set),
the CLI grammar, and the fit that detects a contact-rate drop.

The oracle is `repro.kernels.ref.abc_sim_distance_ref(..., schedule=...)`,
jitted with (population, a0, r0, d0) as run-time values, as the kernels
read them (see tests/test_torch_abc_sim.py). Inputs (theta, the observed
series) come from `repro` at test time and cross as numpy arrays. Bars:
rtol=2e-6, atol=1e-3 (tests/test_interventions.py:169); for seiard with two
inferred windows, at least 99% of samples inside that bar and every one
inside rtol=1e-5, because one sample of 384 lands a floor() apart there
(472003.72 against 472001.0, 5.8e-6 relative): the port sides with the
eager steps, the jitted oracle rounds one hazard differently, as the pinned
`oracle` and `pallas` distances already differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.priors import schedule_prior as jax_schedule_prior
from repro.epi import engine as jengine
from repro.epi.models import get_model as jax_get_model
from repro.epi.spec import EpiModelConfig as JaxEpiModelConfig
from repro.epi.spec import InterventionSchedule as JaxSchedule
from repro.kernels import ref as jref
from repro.launch.abc_run import parse_intervention as jax_parse_intervention
from repro_torch import convert
from repro_torch.core import abc as tabc
from repro_torch.core.priors import schedule_prior
from repro_torch.epi import data as tdata
from repro_torch.epi import engine as tengine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import (
    EMPTY_SCHEDULE,
    EpiModelConfig,
    InterventionSchedule,
    active_schedule,
)
from repro_torch.kernels import abc_sim, ops, ref
from repro_torch.launch import abc_run

torch.set_num_threads(1)

POP = 1e6
KW = dict(population=POP, a0=100.0, r0=5.0, d0=1.0)
BAR = dict(rtol=2e-6, atol=1e-3)


def _observed(name, days, seed=0):
    """repro's threefry series of the model at its default theta."""
    m = jax_get_model(name)
    cfg = JaxEpiModelConfig(population=POP, num_days=days, a0=100.0, r0=5.0, d0=1.0)
    th = jnp.asarray([m.default_theta], jnp.float32)
    return np.asarray(jengine.simulate_observed(m, th, jax.random.PRNGKey(seed), cfg)[0])


def _oracle(name, schedule, theta, seed, obs, kw=KW):
    names = ("population", "a0", "r0", "d0")

    def run(th, ob, *scalars):
        return jref.abc_sim_distance_ref(th, jnp.uint32(seed), ob, model=jax_get_model(name),
                                         schedule=schedule, **dict(zip(names, scalars)))

    scalars = [jnp.float32(kw[n]) for n in names]
    return np.asarray(jax.jit(run)(jnp.asarray(theta), jnp.asarray(obs), *scalars))


def _twin(s: JaxSchedule) -> InterventionSchedule:
    """The port's schedule from repro's fields, as plain tuples."""
    return convert.schedule_from_fields(s.tv_params, s.breakpoints, s.scale_lows,
                                        s.scale_highs)


# ---------------------------------------------------------------- spec layer
def test_schedule_validation():
    with pytest.raises(ValueError, match="strictly increasing"):
        InterventionSchedule.inferred(("alpha",), (10, 10))
    with pytest.raises(ValueError, match="positive"):
        InterventionSchedule.inferred(("alpha",), (0,))
    with pytest.raises(ValueError, match="no tv_params"):
        InterventionSchedule((), (5,), ((0.5,),), ((0.5,),))
    with pytest.raises(ValueError, match="not a parameter"):
        InterventionSchedule.inferred(("nope",), (5,)).shape(get_model("sir"))
    with pytest.raises(ValueError, match="at most 16"):
        InterventionSchedule.inferred(("beta",), tuple(range(1, 18)))
    with pytest.raises(ValueError, match="twice"):
        InterventionSchedule.inferred(("beta", "beta"), (5,))
    s = InterventionSchedule.fixed(("alpha",), (10, 20), (0.3, 0.8))
    assert s.n_windows == 2 and s.n_tv == 1 and s.n_scales == 2
    assert s.fixed_scales() == ((0.3,), (0.8,))
    assert s.scale_param_names() == ("alpha_w1", "alpha_w2")
    m = get_model("siard")
    assert s.param_width(m) == m.n_params + 2
    assert s.shape(m).tv_indices == (m.param_names.index("alpha"),)
    j = JaxSchedule.fixed(("alpha",), (10, 20), (0.3, 0.8))
    assert (_twin(j), _twin(j).tag()) == (s, j.tag())
    assert active_schedule(EMPTY_SCHEDULE) is None and active_schedule(s) is s
    with pytest.raises(TypeError, match="InterventionSchedule"):
        active_schedule(j)


def test_schedule_prior_widens_and_pins():
    m = get_model("siard")
    s = InterventionSchedule(("alpha",), (10, 20), ((0.4,), (0.2,)), ((0.4,), (1.0,)))
    p = schedule_prior(m, s)
    want = jax_schedule_prior(jax_get_model("siard"), _jax(s))
    assert (p.lows, p.highs) == (tuple(want.lows), tuple(want.highs))
    assert p.dim == m.n_params + 2
    assert p.lows[-2:] == (0.4, 0.2) and p.highs[-2:] == (0.4, 1.0)
    th = p.sample(0, 64)
    # the pinned dimension samples exactly its value; log_pdf stays finite
    assert (th[:, -2] == np.float32(0.4)).all()
    assert torch.isfinite(p.log_pdf(th)).all()
    assert schedule_prior(m, None) == m.prior() == schedule_prior(m, EMPTY_SCHEDULE)


def _jax(s: InterventionSchedule) -> JaxSchedule:
    return JaxSchedule(s.tv_params, s.breakpoints, s.scale_lows, s.scale_highs)


# -------------------------------------------------------------- engine layer
@pytest.mark.parametrize("day", [0, 3, 4, 7, 8, 11])
def test_effective_theta_matches_repro(day):
    """The day-effective parameters, bitwise repro's, in every window."""
    m = get_model("seiard")
    s = InterventionSchedule.inferred(("alpha0", "beta"), (4, 8), 0.2, 1.5)
    th = np.asarray(jax_schedule_prior(jax_get_model("seiard"), _jax(s))
                    .sample(jax.random.PRNGKey(day), (64,)))
    want = np.asarray(jengine.effective_theta(jax_get_model("seiard"), _jax(s), th, day))
    got = tengine.effective_theta(m, s, torch.from_numpy(th), day).numpy()
    assert got.shape == (64, m.n_params)
    np.testing.assert_array_equal(got, want)


def test_engine_empty_schedule_bit_identical():
    m = get_model("siard")
    cfg = EpiModelConfig(population=POP, num_days=15, a0=100.0)
    th = m.prior().sample(1, 16)
    base = tengine.simulate_observed(m, th, 2, cfg)
    for sched in (None, EMPTY_SCHEDULE):
        assert torch.equal(tengine.simulate_observed(m, th, 2, cfg, sched), base)
    obs = torch.from_numpy(_observed("siard", 15))
    d0 = ref.abc_sim_distance_ref(th, 2, obs, model=m, **KW)
    d1 = ref.abc_sim_distance_ref(th, 2, obs, model=m, schedule=EMPTY_SCHEDULE, **KW)
    assert torch.equal(d0, d1)


@pytest.mark.parametrize("name,tv", [("siard", ("alpha", "gamma")), ("sir", ("beta",)),
                                     ("seir", ("sigma", "gamma")), ("seiard", ("alpha0",))])
def test_engine_unit_scales_bit_identical(name, tv):
    """Scales pinned at 1.0 change no bit of the trajectory or the distance."""
    m = get_model(name)
    cfg = EpiModelConfig(population=POP, num_days=15, a0=100.0)
    th = m.prior().sample(1, 16)
    sched = InterventionSchedule.fixed(tv, (5, 10), ((1.0,) * len(tv),) * 2)
    thw = torch.cat([th, torch.ones(16, sched.n_scales)], dim=1)
    assert torch.equal(tengine.simulate_observed(m, thw, 2, cfg, sched),
                       tengine.simulate_observed(m, th, 2, cfg))
    obs = torch.from_numpy(_observed(name, 15))
    assert torch.equal(ref.abc_sim_distance_ref(thw, 3, obs, model=m, schedule=sched, **KW),
                       ref.abc_sim_distance_ref(th, 3, obs, model=m, **KW))


def test_engine_contact_drop_suppresses_epidemic():
    """Scaling the contact rate to 0 from day 10: the series agree before the
    breakpoint, and after it the confirmed cases stop growing from new
    infections as they do without the drop."""
    m = get_model("siard")
    cfg = EpiModelConfig(population=POP, num_days=30, a0=100.0)
    th = torch.tensor([m.default_theta])
    base = tengine.simulate_observed(m, th, 0, cfg)
    sched = InterventionSchedule.fixed(("alpha0", "alpha"), (10,), ((0.0, 0.0),))
    locked = tengine.simulate_observed(m, torch.cat([th, torch.zeros(1, 2)], 1), 0, cfg, sched)
    assert torch.equal(base[..., :10], locked[..., :10])
    assert float(base[0, :, -1].sum()) > float(locked[0, :, -1].sum())


def test_synthetic_dataset_takes_fixed_scales_only():
    fixed = InterventionSchedule.fixed(("alpha0",), (10,), (0.1,))
    ds = tdata.synthetic_dataset(theta=tdata.SYNTH_SMALL_THETA, population=POP, num_days=20,
                                 seed=11, schedule=fixed)
    flat = tdata.synthetic_dataset(theta=tdata.SYNTH_SMALL_THETA, population=POP, num_days=20,
                                   seed=11)
    np.testing.assert_array_equal(ds.observed[:, :10], flat.observed[:, :10])
    assert not np.array_equal(ds.observed, flat.observed)
    with pytest.raises(ValueError, match="fixed_scales"):
        tdata.synthetic_dataset(theta=tdata.SYNTH_SMALL_THETA, population=POP, num_days=20,
                                schedule=InterventionSchedule.inferred(("alpha0",), (10,)))


# -------------------------------------------------------------- kernel layer
_SCHEDULES = {
    "one_window_fixed": lambda tv: JaxSchedule.fixed((tv,), (4,), (0.3,)),
    "two_window_inferred": lambda tv: JaxSchedule.inferred((tv,), (3, 8), low=0.2, high=1.5),
}


@pytest.mark.parametrize("name,tv", [("siard", "alpha"), ("sir", "beta"), ("seir", "beta"),
                                     ("seiard", "alpha0")])
@pytest.mark.parametrize("sched_name", sorted(_SCHEDULES))
def test_plain_version_matches_repro_oracle_under_schedule(name, tv, sched_name):
    """The cases of tests/test_interventions.py:142-170 (384 samples, 12
    days, seed 7), on every flat model."""
    jsched = _SCHEDULES[sched_name](tv)
    obs = _observed(name, 12)
    th = np.asarray(jax_schedule_prior(jax_get_model(name), jsched)
                    .sample(jax.random.PRNGKey(12), (384,)))
    got = ops.abc_sim_distance(torch.from_numpy(th), 7, torch.from_numpy(obs),
                               model=get_model(name), schedule=_twin(jsched), **KW).numpy()
    want = _oracle(name, jsched, th, 7, obs)
    if (name, sched_name) == ("seiard", "two_window_inferred"):
        inside = np.abs(got - want) <= BAR["atol"] + BAR["rtol"] * np.abs(want)
        assert inside.mean() >= 0.99, inside.mean()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(got, want, **BAR)


def test_breakpoint_sweep_is_one_shape():
    """Lockdown days are run-time values: schedules that differ only in their
    days pack the same shape and differ only in the breakpoint lanes."""
    m = get_model("siard")
    packed = []
    for day in (3, 5, 7):
        sched = InterventionSchedule.fixed(("alpha",), (day,), (0.5,))
        _, iconst = abc_sim.pack_consts(population=POP, a0=100.0, r0=0.0, d0=0.0,
                                        mean_scale=1.0, weights=[1, 1, 1],
                                        flags=(0, 0, 2, 1, 1), seed=1, model=m,
                                        schedule=sched)
        packed.append(iconst)
        assert abc_sim.theta_width(m, iconst) == m.n_params + 1
    lanes = np.nonzero(packed[0] != packed[1])[0].tolist()
    assert lanes == [abc_sim.I_BREAKPOINTS]
    assert packed[2][abc_sim.I_TV_SLOT + m.param_names.index("alpha")] == 0
    assert (packed[2][abc_sim.I_TV_SLOT:abc_sim.I_TV_SLOT + m.n_params] >= 0).sum() == 1


def test_sim_refuses_a_theta_without_the_scale_columns():
    m = get_model("sir")
    sched = InterventionSchedule.inferred(("beta",), (4, 8))
    sim = ops.make_abc_sim(torch.from_numpy(_observed("sir", 10)), model=m, schedule=sched,
                           **KW)
    with pytest.raises(ValueError, match=r"\[B, 5\]"):
        sim(torch.zeros(8, 3), 0)
    with pytest.raises(ValueError, match="dimensions"):
        sim.wave(m.prior(), 0, 0, 16)
    theta, dist = sim.wave(schedule_prior(m, sched), 4, 5, 64)
    assert theta.shape == (64, 5)
    assert torch.equal(theta, schedule_prior(m, sched).sample(4, 64))
    assert torch.equal(dist, sim(theta, 5))


# ------------------------------------------------------------------ ABC layer
def _abc_cfg(**kw):
    base = dict(batch_size=2048, tolerance=5e3, target_accepted=20, strategy="outfeed",
                chunk_size=2048, max_runs=20, num_days=12, model="siard")
    base.update(kw)
    return tabc.ABCConfig(**base)


def test_run_abc_empty_schedule_same_accepted_set():
    """schedule=None and an empty schedule give the same accepted set."""
    ds = tdata.get_dataset("synthetic_small", num_days=12)
    p_none = tabc.run_abc(ds, _abc_cfg(), seed=0, device="cpu")
    p_empty = tabc.run_abc(ds, _abc_cfg(schedule=EMPTY_SCHEDULE), seed=0, device="cpu")
    assert len(p_none) > 0
    np.testing.assert_array_equal(p_none.theta, p_empty.theta)
    np.testing.assert_array_equal(p_none.distances, p_empty.distances)
    assert p_none.runs == p_empty.runs
    assert tuple(p_empty.param_names) == tuple(p_none.param_names)


def test_run_abc_under_a_schedule_carries_the_scale_columns():
    ds = tdata.get_dataset("synthetic_small", num_days=12)
    sched = InterventionSchedule(("alpha", "gamma"), (6,), ((0.5, 0.0),), ((0.5, 2.0),))
    post = tabc.run_abc(ds, _abc_cfg(schedule=sched, tolerance=8e3), seed=0, device="cpu")
    assert len(post) > 0 and post.theta.shape[1] == 10
    assert tuple(post.param_names[-2:]) == ("alpha_w1", "gamma_w1")
    assert (post.theta[:, -2] == np.float32(0.5)).all()
    # a checkpoint of the other width is refused
    state = tabc.ABCState(n_params=8)
    with pytest.raises(ValueError, match="wrong checkpoint"):
        tabc.run_abc(ds, _abc_cfg(schedule=sched), state=state, device="cpu")


def test_intervention_fit_recovers_contact_drop():
    """The twin of tests/test_interventions.py:225: a SIARD series with
    alpha0 x0.1 from day 10 (the port's own hash series, seed 11), fitted
    with an inferred window; the same fit on the series without the drop
    must place the scale clearly higher."""
    days = 24
    theta = (0.4, 30.0, 0.8, 0.05, 0.3, 0.01, 0.5, 1.0)
    fit = InterventionSchedule.inferred(("alpha0",), (10,), 0.0, 2.0)
    means = {}
    for label, gen in (("drop", InterventionSchedule.fixed(("alpha0",), (10,), (0.1,))),
                       ("flat", None)):
        ds = tdata.synthetic_dataset(theta=theta, population=POP, num_days=days, a0=100.0,
                                     seed=11, name=f"synthetic_{label}", model="siard",
                                     schedule=gen)
        cfg = _abc_cfg(batch_size=8192, num_days=days, schedule=fit, target_accepted=40,
                       max_runs=40, chunk_size=8192)
        eps = tabc.calibrate_tolerance(ds, cfg, seed=1, quantile=1e-3, n_pilot=16384,
                                       device="cpu")
        post = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps), seed=1, device="cpu")
        assert len(post) >= 40
        assert post.param_names[-1] == "alpha0_w1"
        means[label] = float(post.theta[:, -1].mean())
    assert means["drop"] < 0.9, means
    assert means["flat"] > means["drop"] + 0.2, means


# ------------------------------------------------------------------ the CLI
@pytest.mark.parametrize("text", ["", "none", "alpha@25=0.3", "alpha@25=0.1:1,40",
                                  "alpha+gamma@30=0.5+0.8", "beta@3,8=0.2:1.5",
                                  "alpha0@25=0:2"])
def test_parse_intervention_grammar(text):
    """The fields of repro's parse on the grammar cases of
    tests/test_interventions.py:385."""
    got, want = abc_run.parse_intervention(text), jax_parse_intervention(text)
    if want is None:
        assert got is None
        return
    assert got == _twin(want)
    assert abc_run.parse_intervention("alpha@25=0.1:1,40").scale_highs == ((1.0,), (2.0,))


def test_parse_intervention_refuses_what_repro_refuses():
    for bad in ("alpha25", "@5", "alpha+gamma@5=0.1+0.2+0.3"):
        with pytest.raises(ValueError):
            jax_parse_intervention(bad)
        with pytest.raises(ValueError):
            abc_run.parse_intervention(bad)


def test_cli_intervention_on_the_cpu():
    """--intervention widens the posterior; --model seiard fits Italy. A
    tolerance that takes every finite distance keeps the run to one wave."""
    post = abc_run.main(["--device", "cpu", "--dataset", "synthetic_small", "--days", "10",
                         "--batch", "1024", "--chunk", "256", "--tolerance", "1e30",
                         "--accept", "10", "--max-runs", "5",
                         "--intervention", "alpha0@5=0:2"])
    assert len(post) >= 10 and post.theta.shape[1] == 9 and post.runs == 1
    assert post.param_names[-1] == "alpha0_w1"
    post = abc_run.main(["--device", "cpu", "--dataset", "italy", "--model", "seiard",
                         "--days", "10", "--batch", "1024", "--chunk", "256",
                         "--tolerance", "1e30", "--accept", "10", "--max-runs", "5"])
    assert len(post) >= 10 and tuple(post.param_names) == get_model("seiard").param_names
