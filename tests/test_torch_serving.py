"""The port's serving layer (`repro_torch.core.serving`) held against `repro`.

Cross-package, bitwise: `bands_payload` of one trajectory stack,
`dataset_version`, dataset files and the `PosteriorStore` written by either
package and read by the other, `EpiServer.posterior_key`,
`ForecastQuery.from_json` and `_widen_for_schedule`. The forecast core
(`ForecastKernelCache`'s callables over `epi.engine.simulate_observed`),
reduced to Euclidean distances against one particle's trajectory, meets
`repro`'s jitted oracle `kernels/ref.py::abc_sim_distance_ref` at
rtol=2e-6, atol=1e-3 (tests/test_kernel_abc_sim.py:58), with the dataset
scalars as run-time arguments. Then the port's own contracts, as
tests/test_serving.py states them, on the CPU (`device="cpu"`: the plain
version; the card runs the same code through the kernel, `chip_smoke.py`
phases `forecast_path` and `epi_serve`). The subsample and the forecast
draw from counter-hash streams of the query seed, not threefry, so those
are held to `repro` by statistics, not bitwise.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serving as jserving
from repro.core.posterior import Posterior as JaxPosterior
from repro.core.smc import SMCConfig as JaxSMCConfig
from repro.epi.data import CountryData as JaxCountryData
from repro.epi.data import synthetic_dataset as jax_synthetic_dataset
from repro.epi.models import get_model as jax_get_model
from repro.epi.spec import EMPTY_SCHEDULE as JAX_EMPTY
from repro.kernels import ref as jref
from repro.launch.abc_run import parse_intervention as jax_parse_intervention
from repro_torch import convert
from repro_torch.core import serving as tserving
from repro_torch.core.abc import ABCConfig
from repro_torch.core.posterior import Posterior
from repro_torch.core.serving import (
    EpiServer,
    ForecastKernelCache,
    ForecastQuery,
    PosteriorStore,
    ServeConfig,
    dataset_version,
    forecast_bands,
    forecast_seed,
    load_dataset_file,
    save_dataset_file,
    subsample_particles,
)
from repro_torch.core.smc import SMCConfig, run_smc_abc
from repro_torch.epi import engine
from repro_torch.epi.data import synthetic_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import EMPTY_SCHEDULE, EpiModelConfig, InterventionSchedule
from repro_torch.launch import abc_serve
from repro_torch.launch.abc_run import parse_intervention, posterior_forecast

torch.set_num_threads(1)

#: tests/test_kernel_abc_sim.py:58
BAR = dict(rtol=2e-6, atol=1e-3)
#: tests/test_posterior_recovery.py: 15 days, population 1e6, the truths and
#: the normalized error budget
DAYS, POP, REL_TOL = 15, 1e6, 0.30
TRUTH = {"sir": (0.5, 0.2, 1.0), "seir": (0.6, 0.3, 0.2, 1.0)}
QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)
#: (population, a0, r0, d0) of Italy and New Zealand (epi.data.COUNTRY_META)
ITALY = (60.36e6, 155.0, 2.0, 3.0)
NEW_ZEALAND = (4.917e6, 102.0, 0.0, 0.0)

TINY_FIT = SMCConfig(
    n_particles=16, batch_size=256, n_rounds=1, quantile=0.5, num_days=8,
    model="siard", wave_loop="device",
)


def _fake_posterior(model="siard", n=48, seed=0) -> Posterior:
    """Prior samples standing in for a fit: forecasting is fit-agnostic."""
    spec = get_model(model)
    theta = spec.prior().sample(seed, n, "cpu").numpy()
    return Posterior(theta=theta, distances=np.arange(n, dtype=np.float32),
                     tolerance=1.0, param_names=spec.param_names)


def _series(seed, channels=3, days=9):
    return np.random.default_rng(seed).gamma(2.0, 400.0, (channels, days)).astype(np.float32)


def _twins(obs, name="toy", scalars=ITALY, model="siard", channels=("A", "R", "D")):
    """The same dataset in both packages."""
    pop, a0, r0, d0 = scalars
    mine = convert.country_data_from_arrays(name, pop, a0, r0, d0, obs, model=model)
    theirs = JaxCountryData(name=name, population=pop, a0=a0, r0=r0, d0=d0, observed=obs,
                            model=model, observed_channels=channels)
    return mine, theirs


# ------------------------------------------------- cross-package, bitwise
@pytest.mark.parametrize("schedule", [None, "alpha@5=0.5", "alpha0+alpha@3=0.2,7=0.9"])
def test_bands_payload_equals_repros(schedule):
    traj = np.random.default_rng(3).gamma(2.0, 500.0, (40, 3, 12)).astype(np.float32)
    mine_ds, jax_ds = _twins(_series(4))
    mine = tserving.bands_payload(traj, get_model("siard"), mine_ds, 9, 3,
                                  parse_intervention(schedule or ""), QUANTILES)
    theirs = jserving.bands_payload(traj, jax_get_model("siard"), jax_ds, 9, 3,
                                    jax_parse_intervention(schedule or ""), QUANTILES)
    assert mine == theirs
    json.dumps(mine, allow_nan=False)


@pytest.mark.parametrize("model,channels", [("siard", ("A", "R", "D")), ("sir", ("I", "R"))])
def test_dataset_version_equals_repros(model, channels):
    obs = _series(5, channels=len(channels))
    mine, theirs = _twins(obs, model=model, channels=channels)
    assert dataset_version(mine) == jserving.dataset_version(theirs)
    bumped = obs.copy()
    bumped[0, -1] += 1.0
    assert dataset_version(_twins(bumped, model=model, channels=channels)[0]) != (
        dataset_version(mine))


def test_dataset_files_cross_packages(tmp_path):
    """Either package loads what the other wrote, byte for byte the same
    file, with the same version, re-tagging and errors."""
    mine, theirs = _twins(_series(6), name="served")
    jserving.save_dataset_file(str(tmp_path / "jax.json"), theirs)
    save_dataset_file(str(tmp_path / "port.json"), mine)
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    got = load_dataset_file(str(tmp_path / "jax.json"))
    back = jserving.load_dataset_file(str(tmp_path / "port.json"))
    for ds in (got, back):
        np.testing.assert_array_equal(ds.observed, mine.observed)
        assert (ds.name, ds.population, ds.a0, ds.r0, ds.d0, ds.model,
                tuple(ds.observed_channels)) == ("served", *ITALY, "siard", ("A", "R", "D"))
    assert dataset_version(got) == jserving.dataset_version(back) == dataset_version(mine)
    # model= re-tags a series whose channels the model observes
    assert (load_dataset_file(str(tmp_path / "jax.json"), model="seiard").model
            == jserving.load_dataset_file(str(tmp_path / "port.json"), model="seiard").model
            == "seiard")
    for load in (load_dataset_file, jserving.load_dataset_file):
        with pytest.raises(ValueError, match="observes"):
            load(str(tmp_path / "port.json"), model="sir")
    bad = tmp_path / "bad.json"
    bad.write_text('{"name": "x"}')
    with pytest.raises(ValueError, match="malformed") as mine_err:
        load_dataset_file(str(bad))
    with pytest.raises(ValueError, match="malformed") as jax_err:
        jserving.load_dataset_file(str(bad))
    assert str(mine_err.value) == str(jax_err.value)


def _posterior_pair(seed, n=8):
    rng = np.random.default_rng(seed)
    fields = dict(theta=rng.random((n, 3)).astype(np.float32),
                  distances=rng.random(n).astype(np.float32), tolerance=0.5,
                  param_names=("beta", "gamma", "kappa"), runs=3, simulations=4096 * n,
                  weights=rng.random(n).astype(np.float32))
    return Posterior(**fields), JaxPosterior(**fields)


def _assert_same_posterior(a, b):
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.distances, b.distances)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert (a.tolerance, list(a.param_names), a.runs, a.simulations) == (
        b.tolerance, list(b.param_names), b.runs, b.simulations)


def test_posterior_store_crosses_packages(tmp_path):
    """A store written by either package is read by the other; each swap
    prunes the superseded payload, whoever wrote it."""
    mine_store, jax_store = PosteriorStore(str(tmp_path)), jserving.PosteriorStore(str(tmp_path))
    p1, _ = _posterior_pair(1)
    _, j2 = _posterior_pair(2)
    p3, _ = _posterior_pair(3)

    def payloads():
        return sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))

    mine_store.put("italy__siard", "v1", p1)
    _assert_same_posterior(jax_store.get("italy__siard", "v1"), p1)
    jax_store.put("italy__siard", "v2", j2)
    assert mine_store.get("italy__siard", "v1") is None
    _assert_same_posterior(mine_store.get("italy__siard", "v2"), j2)
    assert payloads() == ["italy__siard-v2.npz"]
    mine_store.put("italy__siard", "v3", p3)
    version, latest = jax_store.latest("italy__siard")
    assert version == "v3" and payloads() == ["italy__siard-v3.npz"]
    _assert_same_posterior(latest, p3)
    index = json.loads((tmp_path / "index.json").read_text())
    assert set(index["italy__siard"]) == {"version", "file", "n", "simulations",
                                          "tolerance", "updated_at"}
    assert mine_store.keys() == jax_store.keys() == ("italy__siard",)


#: fit templates: (schedule, summary, distance)
TEMPLATES = [(None, None, "euclidean"), ("alpha@20=0.5", None, "euclidean"),
             ("alpha0+alpha@10=0:2,20", "weekly", "normalized_euclidean"),
             (None, "cumulative", "mae")]


@pytest.mark.parametrize("template", range(len(TEMPLATES)))
def test_posterior_key_equals_repros(template):
    sched, summary, distance = TEMPLATES[template]
    mine = EpiServer(ServeConfig(fit=SMCConfig(schedule=parse_intervention(sched or ""),
                                               summary=summary, distance=distance)),
                     device="cpu")
    theirs = jserving.EpiServer(jserving.ServeConfig(fit=JaxSMCConfig(
        schedule=jax_parse_intervention(sched or ""), summary=summary, distance=distance)))
    for name, model in (("italy", "siard"), ("toy", "sir")):
        assert mine.posterior_key(name, model) == theirs.posterior_key(name, model)


QUERIES = [
    {"dataset": "italy"},
    {"dataset": "italy", "model": "siard", "horizon": 10, "schedule": "alpha@5=0.5", "seed": 3},
    {"dataset": "toy", "model": "sir", "schedule": "none", "quantiles": [0.1, 0.9]},
    {"dataset": "usa", "schedule": "", "horizon": "7"},
    {"dataset": "nz", "schedule": "alpha0+alpha@3=0.2,9=0.7+0.8", "seed": "12"},
]


@pytest.mark.parametrize("query", range(len(QUERIES)))
def test_forecast_query_from_json_equals_repros(query):
    mine = ForecastQuery.from_json(QUERIES[query])
    theirs = jserving.ForecastQuery.from_json(QUERIES[query])
    for field in ("dataset", "model", "horizon", "quantiles", "seed", "kind"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert (mine.schedule is None) == (theirs.schedule is None)
    if mine.schedule is not None:
        assert dataclasses.asdict(mine.schedule) == dataclasses.asdict(theirs.schedule)
        assert (mine.schedule is EMPTY_SCHEDULE) == (theirs.schedule is JAX_EMPTY)


def test_forecast_query_errors_equal_repros():
    bad = {"dataset": "italy", "schedule": {"day": 5}}
    with pytest.raises(ValueError, match="grammar string") as mine:
        ForecastQuery.from_json(bad)
    with pytest.raises(ValueError) as theirs:
        jserving.ForecastQuery.from_json(bad)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("counterfactual,schedule", [
    (False, None), (False, "alpha@5=0.5"), (True, None), (True, "none"),
    (True, "alpha@5=0.5"), (True, "alpha0+alpha@3=0.2,9=0.7+0.8")])
def test_widen_for_schedule_equals_repros(counterfactual, schedule):
    theta = np.random.default_rng(8).random((16, 9)).astype(np.float32)
    if schedule is None:
        mine_s = theirs_s = None
    elif schedule == "none":
        mine_s, theirs_s = EMPTY_SCHEDULE, JAX_EMPTY
    else:
        mine_s, theirs_s = parse_intervention(schedule), jax_parse_intervention(schedule)
    mine = tserving._widen_for_schedule(get_model("siard"), theta, counterfactual, mine_s)
    theirs = jserving._widen_for_schedule(jax_get_model("siard"), theta, counterfactual,
                                          theirs_s)
    assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)


# ------------------------------------------------- the forecast core
def _oracle(model, schedule, theta, seed, obs, scalars):
    """repro's jitted oracle with (population, a0, r0, d0) as run-time
    values, as the kernels read them (tests/test_torch_abc_sim.py)."""
    names = ("population", "a0", "r0", "d0")

    def run(th, ob, *values):
        return jref.abc_sim_distance_ref(th, jnp.uint32(seed), ob, model=jax_get_model(model),
                                         schedule=schedule, **dict(zip(names, values)))

    values = [jnp.float32(v) for v in scalars]
    return np.asarray(jax.jit(run)(jnp.asarray(theta), jnp.asarray(obs), *values))


def _box_theta(spec, schedule, n, seed):
    """n parameter rows, uniform in the prior box, from numpy."""
    lo = np.asarray(spec.prior().lows, np.float32)
    hi = np.asarray(spec.prior().highs, np.float32)
    theta = np.random.default_rng(seed).uniform(lo, hi, (n, lo.size)).astype(np.float32)
    if schedule is not None:
        scales = np.asarray([s for row in schedule.fixed_scales() for s in row], np.float32)
        theta = np.concatenate([theta, np.broadcast_to(scales, (n, scales.size))], axis=1)
    return theta


#: (model, forecast schedule) cells of the oracle comparison
CORE_CELLS = [("siard", None), ("siard", "alpha0@6=0.4"), ("sir", None), ("seiard", None),
              ("seir", "beta@4=0.5,9=1.5")]


@pytest.mark.parametrize("model,schedule", CORE_CELLS)
def test_forecast_core_meets_repros_oracle(model, schedule):
    """Two lanes (Italy's and New Zealand's scalars, two query seeds) of one
    batched call: each lane's trajectories, reduced to Euclidean distances
    against its particle 0, equal repro's oracle run at that lane's theta,
    forecast seed and scalars against particle 0's trajectory."""
    spec = get_model(model)
    sched = parse_intervention(schedule or "")
    jax_sched = jax_parse_intervention(schedule or "")
    n, days = 64, 14
    theta = np.stack([_box_theta(spec, sched, n, 20 + lane) for lane in range(2)])
    seeds = [forecast_seed(s) for s in (3, 4)]
    lanes = np.asarray([ITALY, NEW_ZEALAND], np.float32)
    _, batched = ForecastKernelCache().get(spec, days, n, theta.shape[2], sched)
    bp = torch.tensor([list(sched.breakpoints) if sched else []] * 2, dtype=torch.int64)
    traj = batched(torch.from_numpy(theta), torch.tensor(seeds), *torch.from_numpy(lanes).T,
                   bp).numpy()
    assert traj.shape == (2, n, spec.n_observed, days)
    for lane in range(2):
        t = traj[lane].astype(np.float64)
        mine = np.sqrt(((t - t[0]) ** 2).sum(axis=(1, 2)))
        theirs = _oracle(model, jax_sched, theta[lane], seeds[lane], traj[lane][0],
                         lanes[lane])
        np.testing.assert_allclose(mine, theirs, **BAR)


@pytest.mark.parametrize("model,schedule", CORE_CELLS + [("metapop_seir", None)])
def test_each_lane_is_bitwise_its_solo_simulation(model, schedule):
    """Lane l of a batched call is bitwise `simulate_observed` for lane l
    alone, with its int seed, Python-float scalars and the schedule's own
    breakpoint days; `single` is the same."""
    spec = get_model(model)
    sched = parse_intervention(schedule or "")
    n, days, lanes = 24, 12, 3
    theta = np.stack([_box_theta(spec, sched, n, 40 + lane) for lane in range(lanes)])
    seeds = [forecast_seed(s) for s in (0, 1, 2)]
    scalars = [ITALY, NEW_ZEALAND, (1e6, 100.0, 0.0, 0.0)]
    single, batched = ForecastKernelCache().get(spec, days, n, theta.shape[2], sched)
    bp = torch.tensor([list(sched.breakpoints) if sched else []] * lanes, dtype=torch.int64)
    traj = batched(torch.from_numpy(theta), torch.tensor(seeds),
                   *torch.from_numpy(np.asarray(scalars, np.float32)).T, bp)
    for lane in range(lanes):
        pop, a0, r0, d0 = scalars[lane]
        cfg = EpiModelConfig(population=pop, num_days=days, a0=a0, r0=r0, d0=d0)
        solo = engine.simulate_observed(spec, torch.from_numpy(theta[lane]), seeds[lane], cfg,
                                        sched)
        assert torch.equal(traj[lane], solo), lane
        alone = single(torch.from_numpy(theta[lane]), seeds[lane],
                       *np.asarray(scalars[lane], np.float32), bp[lane])
        assert torch.equal(alone, solo), lane


@pytest.mark.parametrize("model", ["siard", "sir", "seir", "seiard", "metapop_seir"])
def test_engine_run_time_values_keep_the_scalar_results(model):
    """A seed and dataset scalars given a row a sample, and a breakpoint
    override, give bitwise the results of the scalar call."""
    spec = get_model(model)
    tv = {"siard": "alpha", "sir": "beta", "seir": "beta", "seiard": "alpha0",
          "metapop_seir": "beta"}[model]
    b = 16
    theta = torch.from_numpy(_box_theta(spec, None, b, 9))
    cfg = EpiModelConfig(population=ITALY[0], num_days=12, a0=ITALY[1], r0=ITALY[2],
                         d0=ITALY[3])

    def rows(x):
        return torch.full((b,), float(np.float32(x)), dtype=torch.float32)

    per_row = EpiModelConfig(population=rows(ITALY[0]), num_days=12, a0=rows(ITALY[1]),
                             r0=rows(ITALY[2]), d0=rows(ITALY[3]))
    want = engine.simulate_observed(spec, theta, 77, cfg)
    got = engine.simulate_observed(spec, theta, torch.full((b,), 77 + 2**32), per_row)
    assert torch.equal(got, want)
    sched = InterventionSchedule.fixed((tv,), (4, 9), (0.3, 0.7))
    later = InterventionSchedule.fixed((tv,), (5, 10), (0.3, 0.7))
    wide = torch.cat([theta, torch.tensor([[0.3, 0.7]]).expand(b, 2)], dim=1)
    want = engine.simulate_observed(spec, wide, 77, cfg, sched)
    for bp in ((4, 9), torch.tensor([4, 9]), torch.tensor([[4, 9]] * b)):
        got = engine.simulate_observed(spec, wide, 77, per_row, later, breakpoints=bp)
        assert torch.equal(got, want)


# ------------------------------------------------- the port's own contracts
def test_mixed_batch_bit_identical_in_two_batched_calls():
    """tests/test_serving.py:60: 8 queries (4 forecasts + 4
    counterfactuals, two schedule shapes) -> exactly 2 batched calls over 2
    cache entries, responses dict-equal to sequential posterior_forecast."""
    cfg = ServeConfig(slots=4, forecast_particles=32,
                      fit=dataclasses.replace(TINY_FIT, num_days=10))
    server = EpiServer(cfg, device="cpu")
    post = _fake_posterior()
    server.preload("synthetic_small", "siard", post)
    sched = parse_intervention("alpha@5=0.5")
    queries = ([ForecastQuery(dataset="synthetic_small", horizon=7, seed=i) for i in range(4)]
               + [ForecastQuery(dataset="synthetic_small", horizon=7, schedule=sched, seed=i)
                  for i in range(4)])
    responses = server.answer(queries)
    assert len(responses) == 8
    assert server.fits == 0
    assert server.batched_calls == 2
    assert server.kernels.n_compiled == 2
    ds, _ = server.dataset("synthetic_small", "siard")
    acfg = ABCConfig(num_days=10, model="siard")
    for i, q in enumerate(queries):
        seq = posterior_forecast(post.theta, ds, acfg, q.horizon, schedule=q.schedule,
                                 key=q.seed, max_particles=cfg.forecast_particles,
                                 device="cpu")
        assert responses[i] == seq, f"query {i} diverged from sequential"
        json.dumps(responses[i], allow_nan=False)
    assert responses[0] != responses[1]  # the seed moves the bands


def test_padded_final_chunk_still_matches_sequential():
    """tests/test_serving.py:104: padding lanes never leak into responses."""
    server = EpiServer(ServeConfig(slots=4, forecast_particles=16,
                                   fit=dataclasses.replace(TINY_FIT, num_days=10)),
                       device="cpu")
    post = _fake_posterior(n=20)
    server.preload("synthetic_small", "siard", post)
    queries = [
        ForecastQuery(dataset="synthetic_small", horizon=5, seed=7),
        ForecastQuery(dataset="synthetic_small", horizon=5, seed=8),
        ForecastQuery(dataset="synthetic_small", horizon=5, schedule=EMPTY_SCHEDULE, seed=9),
    ]
    responses = server.answer(queries)
    # empty-schedule counterfactuals share the no-schedule forecast shape
    assert server.batched_calls == 1
    ds, _ = server.dataset("synthetic_small", "siard")
    acfg = ABCConfig(num_days=10, model="siard")
    for q, resp in zip(queries, responses):
        assert resp == posterior_forecast(post.theta, ds, acfg, q.horizon,
                                          schedule=q.schedule, key=q.seed, max_particles=16,
                                          device="cpu")


def test_truncated_bands_statistically_match_full_bands():
    """tests/test_serving.py:135: the seeded subsample tracks the full-set
    bands; the first-k rows of a distance-ordered set do not."""
    model = "sir"
    spec = get_model(model)
    n = 512
    raw = spec.prior().sample(3, n, "cpu").numpy()
    truth = np.asarray(TRUTH[model], np.float32)
    theta = truth + (raw - truth) * 0.3
    theta = theta[np.argsort(theta[:, 0])]
    ds = synthetic_dataset(theta=TRUTH[model], population=1e6, num_days=15, a0=100.0,
                           seed=11, name="subsample_ds", model=model)

    def bands(th, k):
        return forecast_bands(th, ds, model=model, fit_days=15, horizon=5, key=4,
                              max_particles=k, device="cpu")

    full = bands(theta, n)
    perm = bands(theta, 128)
    firstk = bands(theta[:128], 128)
    ch = spec.observed[0]
    ref_q50 = np.asarray(full["channels"][ch]["q50"])
    scale = np.abs(ref_q50).mean() + 1.0

    def err(b):
        return np.abs(np.asarray(b["channels"][ch]["q50"]) - ref_q50).mean() / scale

    assert err(perm) < 0.15, "permutation subsample drifted from full bands"
    assert err(perm) < err(firstk), (err(perm), err(firstk))


def test_subsample_is_seeded_and_unbiased():
    """tests/test_serving.py:177."""
    theta = np.arange(1000, dtype=np.float32).reshape(-1, 1)
    a = subsample_particles(theta, 5, 200)
    b = subsample_particles(theta, 5, 200)
    c = subsample_particles(theta, 6, 200)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs(a.mean() - theta.mean()) < 40  # first-k mean: 99.5
    assert len(np.unique(a)) == 200  # a permutation: no particle twice
    np.testing.assert_array_equal(subsample_particles(theta, 5, 1000), theta)


def test_posterior_cache_hit_skips_fitting(tmp_path):
    """tests/test_serving.py:189: in memory, then from the store."""
    def server():
        return EpiServer(ServeConfig(slots=2, forecast_particles=8, fit=TINY_FIT,
                                     store_dir=str(tmp_path / "store")), device="cpu")

    s1 = server()
    q = ForecastQuery(dataset="synthetic_small", horizon=3, seed=0)
    s1.answer([q])
    assert s1.fits == 1
    s1.answer([dataclasses.replace(q, seed=5)])
    assert s1.fits == 1
    s2 = server()
    s2.answer([q])
    assert s2.fits == 0


def test_warm_started_refit_fewer_sims_same_accuracy():
    """tests/test_serving.py:209 on repro's sir recovery series: the warm
    re-fit costs fewer simulations, ends at no larger a tolerance, and meets
    tests/test_posterior_recovery.py's bar."""
    model = "sir"
    jds = jax_synthetic_dataset(theta=TRUTH[model], population=POP, num_days=DAYS, a0=100.0,
                                seed=11, name=f"recovery_{model}", model=model)
    ds = convert.country_data_from_arrays(jds.name, jds.population, jds.a0, jds.r0, jds.d0,
                                          jds.observed, model=model)
    cold_cfg = SMCConfig(n_particles=96, batch_size=4096, n_rounds=3, quantile=0.4,
                         num_days=DAYS, model=model, wave_loop="device")
    cold = run_smc_abc(ds, cold_cfg, seed=1, device="cpu")
    assert cold.weights is not None and cold.weights.shape == (96,)
    warm = run_smc_abc(ds, dataclasses.replace(
        cold_cfg, n_rounds=2, initial_particles=cold.theta, initial_weights=cold.weights),
        seed=2, device="cpu")
    assert warm.simulations < cold.simulations, (warm.simulations, cold.simulations)
    assert warm.tolerance <= cold.tolerance
    prior = get_model(model).prior()
    lo, hi = np.asarray(prior.lows), np.asarray(prior.highs)
    truth = np.asarray(TRUTH[model])
    err = np.abs(warm.theta.mean(axis=0) - truth) / (hi - lo)
    assert (err <= REL_TOL).all(), err
    assert err.mean() < (np.abs((hi + lo) / 2 - truth) / (hi - lo)).mean()


def test_smc_initial_particles_validation():
    """tests/test_serving.py:233."""
    with pytest.raises(ValueError, match="initial_weights"):
        SMCConfig(initial_weights=np.ones(4))
    with pytest.raises(ValueError):
        SMCConfig(initial_particles=np.zeros((0, 3)))
    with pytest.raises(ValueError):
        SMCConfig(initial_particles=np.ones((4, 3)), initial_weights=np.ones(5))
    with pytest.raises(ValueError):
        SMCConfig(initial_particles=np.ones((4, 3)), initial_weights=np.zeros(4))


def test_posterior_store_atomic_swap(tmp_path):
    """tests/test_serving.py:247."""
    store = PosteriorStore(str(tmp_path))
    p1, p2 = _fake_posterior(n=8, seed=1), _fake_posterior(n=8, seed=2)
    store.put("k", "v1", p1)
    assert store.version_of("k") == "v1"
    np.testing.assert_array_equal(store.get("k", "v1").theta, p1.theta)
    store.put("k", "v2", p2)
    assert store.get("k", "v1") is None
    version, latest = store.latest("k")
    assert version == "v2"
    np.testing.assert_array_equal(latest.theta, p2.theta)
    npz = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(npz) == 1 and "v2" in npz[0]


def _write_dataset(path, scale=1.0, num_days=12):
    ds = synthetic_dataset(theta=TRUTH["sir"], population=1e6, num_days=num_days, a0=100.0,
                           seed=11, name="served", model="sir")
    ds = dataclasses.replace(ds, observed=(ds.observed * scale).astype(np.float32))
    save_dataset_file(str(path), ds)
    return ds


def test_dataset_file_round_trip_and_version(tmp_path):
    """tests/test_serving.py:273."""
    path = tmp_path / "served.json"
    ds = _write_dataset(path)
    back = load_dataset_file(str(path))
    np.testing.assert_array_equal(back.observed, ds.observed)
    assert back.name == ds.name and back.population == ds.population
    assert dataset_version(back) == dataset_version(ds)
    _write_dataset(path, scale=1.1)
    assert dataset_version(load_dataset_file(str(path))) != dataset_version(ds)
    with pytest.raises(ValueError, match="malformed"):
        bad = tmp_path / "bad.json"
        bad.write_text('{"name": "x"}')
        load_dataset_file(str(bad))


def test_daemon_refits_on_content_change_with_warm_start(tmp_path):
    """tests/test_serving.py:288."""
    data_dir, store_dir = tmp_path / "data", tmp_path / "store"
    data_dir.mkdir()
    _write_dataset(data_dir / "served.json")
    fit = dataclasses.replace(TINY_FIT, model="sir")

    def make_server():
        return EpiServer(ServeConfig(fit=fit, data_dir=str(data_dir),
                                     store_dir=str(store_dir)), device="cpu")

    s1 = make_server()
    assert s1.refresh("served", "sir") == "cold_fit"
    assert s1.refresh("served", "sir") == "cached"
    _write_dataset(data_dir / "served.json", scale=1.05)
    s2 = make_server()
    assert s2.refresh("served", "sir") == "warm_refit"
    assert s2.warm_fits == 1
    assert s2.refresh("served", "sir") == "cached"


def test_abc_serve_once_cli(tmp_path):
    """tests/test_serving.py:310."""
    data_dir, store_dir = tmp_path / "data", tmp_path / "store"
    data_dir.mkdir()
    _write_dataset(data_dir / "served.json")
    argv = ["--once", "--data-dir", str(data_dir), "--store", str(store_dir),
            "--models", "sir", "--days", "8", "--fit-particles", "16",
            "--fit-batch", "256", "--fit-rounds", "1", "--device", "cpu"]
    assert abc_serve.main(argv) == 1
    assert abc_serve.main(argv) == 0


def test_forecast_query_from_json():
    """tests/test_serving.py:322."""
    q = ForecastQuery.from_json({"dataset": "italy", "model": "siard", "horizon": 10,
                                 "schedule": "alpha@5=0.5", "seed": 3})
    assert q.kind == "counterfactual"
    assert q.schedule.breakpoints == (5,)
    lifted = ForecastQuery.from_json({"dataset": "italy", "schedule": "none"})
    assert lifted.schedule is EMPTY_SCHEDULE and lifted.kind == "counterfactual"
    plain = ForecastQuery.from_json({"dataset": "italy"})
    assert plain.schedule is None and plain.kind == "forecast"
    with pytest.raises(ValueError, match="grammar string"):
        ForecastQuery.from_json({"dataset": "italy", "schedule": {"day": 5}})


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """The server and the sequential forecast take the card unless asked
    for the CPU; without one they raise, nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        EpiServer(ServeConfig())
    post = _fake_posterior(n=4)
    ds = synthetic_dataset(theta=TRUTH["sir"], population=1e6, num_days=5, model="sir")
    with pytest.raises(RuntimeError, match="cuda"):
        forecast_bands(post.theta[:, :3], ds, model="sir", fit_days=5, horizon=2)
