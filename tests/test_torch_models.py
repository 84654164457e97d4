"""The port's flat models (siard, sir, seir, seiard) against `repro`'s.

Each model's rows (seeding, hazards, one tau-leap step) are held to
`repro.epi.engine` on the same numpy state and noise; the plain version of
the fused kernel to the committed pins `tests/data/r1_pins.npz` (theta and
the observed series taken from the file: `repro`'s threefry streams have
moved since they were captured); and the port's `run_abc` to the recovery
bars of tests/test_posterior_recovery.py:76-86 on `repro`'s own series.

Bars: the plain version equals `{model}/pallas` bitwise and `{model}/oracle`
within rtol=2e-6, atol=1e-3 (tests/test_kernel_abc_sim.py:58; the pinned
oracle and Pallas distances themselves differ by up to 1.2e-7 relative).
Hazards agree to rtol=1e-6 (the last ulp of pow differs between XLA and
PyTorch); a tau-leap count may land one apart where that ulp moves floor().
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.epi import engine as jengine
from repro.epi.data import synthetic_dataset as jax_synthetic_dataset
from repro.epi.models import get_model as jax_get_model
from repro.epi.models import list_models as jax_list_models
from repro.epi.spec import EpiModelConfig as JaxEpiModelConfig
from repro_torch import convert
from repro_torch.core import abc as tabc
from repro_torch.core.summaries import get_summary, lower_summary
from repro_torch.epi import data as tdata
from repro_torch.epi import engine as tengine
from repro_torch.epi.models import get_model, list_models
from repro_torch.epi.spec import EpiModelConfig
from repro_torch.kernels import abc_sim, ops

torch.set_num_threads(1)

PINS = os.path.join(os.path.dirname(__file__), "data", "r1_pins.npz")
BAR = dict(rtol=2e-6, atol=1e-3)
FLAT = ("siard", "sir", "seir", "seiard")
#: pinned run: synthetic_small's scalars, hash seed 123, 14 days
PIN_KW = dict(population=1e6, a0=100.0, r0=0.0, d0=0.0)


def _pair(name):
    return get_model(name), jax_get_model(name)


def _theta(name, batch, seed=0):
    return np.asarray(jax_get_model(name).prior().sample(jax.random.PRNGKey(seed), (batch,)))


# ------------------------------------------------------------------ registry
def test_every_flat_repro_model_has_a_twin():
    """Every entry of repro's registry, the flat models and metapop_seir, has
    a port twin with the same declaration, its region axis included; the
    port registers li2020 besides, which repro does not have."""
    flat = tuple(n for n in jax_list_models() if not jax_get_model(n).is_regional)
    assert set(flat) == set(FLAT)
    assert set(list_models()) == set(jax_list_models()) | {"li2020"}
    for name in jax_list_models():
        t, j = _pair(name)
        for field in ("compartments", "param_names", "prior_highs", "stoichiometry",
                      "observed", "default_theta", "n_regions", "mobility", "coupled",
                      "seed_region"):
            want = getattr(j, field)
            assert getattr(t, field) == (tuple(want) if isinstance(want, list) else want), (
                name, field)
        assert t.prior().lows == tuple(j.prior().lows)
        assert t.transition_sources == tuple(j.transition_sources)
        for prop in ("is_regional", "ctr_slots", "total_observed_idx", "observed_labels",
                     "coupled_idx"):
            assert getattr(t, prop) == getattr(j, prop), (name, prop)


@pytest.mark.parametrize("name,ops", [("siard", 14), ("sir", 4), ("seir", 5), ("seiard", 15)])
def test_each_model_states_its_hazard_ops(name, ops):
    """The hazard operations the bound counts (epi/spec.py: before the clamp,
    parameter-only products once a sample), and the sample-day total built on
    them: 60 a transition, the hazards, the counter base, 4 a channel-day."""
    model = get_model(name)
    assert model.hazard_ops == ops
    lowered = lower_summary(get_summary(None), "euclidean", torch.ones(model.n_observed, 49))
    want = 60 * model.n_transitions + ops + 1 + 4 * model.n_observed + 4 / 49
    assert abc_sim.ops_per_sample_day(model, lowered) == pytest.approx(want, rel=1e-12)


def test_kernel_symbols_of_every_model():
    """The mangled names that pick each model's kernel variants out of its
    library's SASS (chip_smoke.py's census finds each exactly once)."""
    flags = (0, 0, 2, 1, 1)
    assert [abc_sim.kernel_symbol(get_model(n), flags, True) for n in FLAT] == [
        "abc_sim_kernelI5SiardLi8EE", "abc_sim_kernelI3SirLi8EE",
        "abc_sim_kernelI4SeirLi8EE", "abc_sim_kernelI6SeiardLi8EE"]
    assert abc_sim.kernel_symbol(get_model("seiard"), (1, 1, 1, 0, 7), False) == \
        "abc_sim_kernelI6SeiardLi7EE"
    assert [abc_sim.library(n) for n in FLAT] == [
        "abc_sim_siard", "abc_sim_sir", "abc_sim_seir", "abc_sim_seiard"]
    assert [abc_sim.variant_symbol(get_model(n), 8) for n in FLAT] == [
        abc_sim.kernel_symbol(get_model(n), flags, True) for n in FLAT]


# -------------------------------------------------------------------- pins
@pytest.mark.parametrize("name", FLAT)
def test_plain_version_equals_the_pins(name):
    """Bitwise `{model}/pallas`, and `{model}/oracle` within the bar."""
    pins = np.load(PINS)
    got = ops.abc_sim_distance(
        torch.from_numpy(np.array(pins[f"{name}/theta"])), 123,
        torch.from_numpy(np.array(pins[f"{name}/observed"])), model=get_model(name),
        **PIN_KW).numpy()
    want = pins[f"{name}/pallas"]
    assert got.shape == want.shape == (16,)
    np.testing.assert_array_equal(got.view(np.uint32), want.astype(np.float32).view(np.uint32))
    np.testing.assert_allclose(got, pins[f"{name}/oracle"], **BAR)


# -------------------------------------------------------------------- rows
def _state(name, batch=512, seed=0):
    rs = np.random.default_rng(seed)
    model = get_model(name)
    state = rs.integers(0, 50_000, size=(batch, model.n_state)).astype(np.float32)
    noise = rs.standard_normal((batch, model.n_transitions)).astype(np.float32)
    return state, noise


@pytest.mark.parametrize("name", FLAT)
def test_initial_state_matches_repro(name):
    t, j = _pair(name)
    theta = _theta(name, 128)
    for kw in (dict(population=1e6, a0=100.0, r0=5.0, d0=1.0),
               dict(population=60.36e6, a0=155.0, r0=2.0, d0=3.0)):
        want = np.asarray(jengine.initial_state(j, theta, JaxEpiModelConfig(num_days=1, **kw)))
        got = tengine.initial_state(t, torch.from_numpy(theta),
                                    EpiModelConfig(num_days=1, **kw)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FLAT)
def test_hazards_match_repro(name):
    t, j = _pair(name)
    theta = _theta(name, 512, seed=1)
    state, _ = _state(name)
    want = np.asarray(jengine.hazards(j, state, theta, 1e6))
    got = tengine.hazards(t, torch.from_numpy(state), torch.from_numpy(theta), 1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got >= 0).all()


@pytest.mark.parametrize("name", FLAT)
def test_tau_leap_step_matches_repro_on_same_noise(name):
    t, j = _pair(name)
    theta = _theta(name, 512, seed=2)
    state, noise = _state(name, seed=2)
    want = np.asarray(jengine.tau_leap_step(j, state, theta, noise, 1e6))
    got = tengine.tau_leap_step(t, torch.from_numpy(state), torch.from_numpy(theta),
                                torch.from_numpy(noise), 1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0)
    assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("name", FLAT)
def test_mass_is_conserved_and_stays_non_negative(name):
    """Integer states under raw counts of either sign: the total is exact and
    no compartment goes negative; a 30-day trajectory keeps its total to
    float32 rounding and stays non-negative."""
    model = get_model(name)
    rs = np.random.default_rng(3)
    state = torch.from_numpy(rs.integers(0, 20, size=(4096, model.n_state)).astype(np.float32))
    raw = torch.from_numpy((rs.standard_normal((4096, model.n_transitions)) * 30)
                           .astype(np.float32))
    nxt = tengine.apply_transitions(model, state, torch.floor(raw))
    torch.testing.assert_close(nxt.sum(-1), state.sum(-1), rtol=0, atol=0)
    assert (nxt >= 0).all()
    theta = torch.from_numpy(_theta(name, 64, seed=4))
    cfg = EpiModelConfig(population=1e5, num_days=30, a0=10.0)
    x = tengine.initial_state(model, theta, cfg)
    total = x.double().sum(-1)
    idx = torch.arange(64)
    for day in range(30):
        z = tengine.krng.hash_normals(5, idx, day, model.n_transitions, 8)
        x = tengine.tau_leap_step(model, x, theta, z, 1e5)
        assert (x >= 0).all() and torch.isfinite(x).all()
    torch.testing.assert_close(x.double().sum(-1), total, rtol=1e-6, atol=0)
    obs = tengine.simulate_observed(model, theta, 5, cfg)
    assert obs.shape == (64, model.n_observed, 30) and (obs >= 0).all()


# ---------------------------------------------------------------- datasets
def test_country_series_go_to_every_model_that_observes_them():
    """seiard fits the SIARD (A, R, D) country series, re-tagged, as in
    repro; sir and seir observe (I, R) and are refused."""
    base = tdata.get_dataset("italy", num_days=12)
    ds = tdata.get_dataset("italy", num_days=12, model="seiard")
    assert ds.model == "seiard" and ds.true_theta is None
    np.testing.assert_array_equal(ds.observed, base.observed)
    assert ds.compatible_with(get_model("seiard"))
    for name in ("sir", "seir"):
        with pytest.raises(ValueError, match="observes"):
            tdata.get_dataset("italy", num_days=12, model=name)
        small = tdata.get_dataset("synthetic_small", num_days=12, model=name)
        assert small.observed.shape == (2, 12)
        assert small.true_theta == get_model(name).default_theta


@pytest.mark.parametrize("name", FLAT)
def test_country_data_from_arrays_for_every_model(name):
    jds = jax_synthetic_dataset(theta=jax_get_model(name).default_theta, population=1e6,
                                num_days=10, a0=100.0, seed=3, model=name)
    ds = convert.country_data_from_arrays(jds.name, jds.population, jds.a0, jds.r0, jds.d0,
                                          jds.observed, true_theta=jds.true_theta, model=name)
    assert ds.model == name and ds.observed_channels == tuple(jds.observed_channels)
    np.testing.assert_array_equal(ds.observed, np.asarray(jds.observed, np.float32))
    with pytest.raises(ValueError, match="observed must be"):
        convert.country_data_from_arrays("x", 1e6, 1.0, 0.0, 0.0, np.zeros((5, 3)), model=name)


# ---------------------------------------------------------------- recovery
#: tests/test_posterior_recovery.py: 15 days, population 1e6, the truths and
#: the normalized error budget
DAYS, POP, REL_TOL = 15, 1e6, 0.30
TRUTH = {"sir": (0.5, 0.2, 1.0), "seir": (0.6, 0.3, 0.2, 1.0)}


@pytest.mark.parametrize("name", ["sir", "seir"])
def test_run_abc_recovers_truth(name):
    """The port's run_abc on repro's own recovery series (threefry,
    `synthetic_dataset(seed=11)`, taken as numpy arrays through
    `convert.country_data_from_arrays`), with the bars of
    tests/test_posterior_recovery.py:63-86: every parameter's posterior mean
    within REL_TOL of the prior width of the truth, and closer on average
    than the prior mean. The tolerance is the 5e-3 quantile of a 4096-sample
    pilot of the port's own."""
    jds = jax_synthetic_dataset(theta=TRUTH[name], population=POP, num_days=DAYS, a0=100.0,
                                seed=11, name=f"recovery_{name}", model=name)
    ds = convert.country_data_from_arrays(jds.name, jds.population, jds.a0, jds.r0, jds.d0,
                                          jds.observed, true_theta=TRUTH[name], model=name)
    cfg = tabc.ABCConfig(batch_size=4096, chunk_size=4096, num_days=DAYS, model=name,
                         tolerance=1.0, max_runs=60, target_accepted=60)
    eps = tabc.calibrate_tolerance(ds, cfg, seed=5, quantile=5e-3, n_pilot=4096, device="cpu")
    import dataclasses

    post = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps), seed=0, device="cpu")
    assert len(post) >= 60
    prior = get_model(name).prior()
    lo, hi = np.asarray(prior.lows), np.asarray(prior.highs)
    truth = np.asarray(TRUTH[name])
    err = np.abs(post.theta.mean(axis=0) - truth) / (hi - lo)
    assert (err <= REL_TOL).all(), (name, err, post.theta.mean(axis=0))
    assert err.mean() < (np.abs((hi + lo) / 2 - truth) / (hi - lo)).mean()
