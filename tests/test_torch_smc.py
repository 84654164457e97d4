"""The port's SMC-ABC against `repro.core.smc`.

The streams are the port's counter hash (device round) and numpy's
`default_rng(seed)` (host round), not `repro`'s threefry, so SMC is held to
`repro` by its validation, its formulas on shared numpy inputs (the
weighted variance and the importance-weight update, at rtol=1e-12) and its
statistics: the recovery bars of tests/test_posterior_recovery.py:89-102
(sir and seir at REL_TOL=0.30, both wave loops) on `repro`'s own series
through `convert.country_data_from_arrays`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import smc as jsmc
from repro.core.priors import UniformBoxPrior as JaxBoxPrior
from repro.core.priors import schedule_prior as jax_schedule_prior
from repro.epi.data import synthetic_dataset as jax_synthetic_dataset
from repro.epi.models import get_model as jax_get_model
from repro.epi.spec import InterventionSchedule as JaxSchedule
from repro_torch import convert
from repro_torch.core import abc as tabc
from repro_torch.core import smc as tsmc
from repro_torch.core.priors import UniformBoxPrior, schedule_prior
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule
from repro_torch.kernels import ref

torch.set_num_threads(1)

#: tests/test_posterior_recovery.py: 15 days, population 1e6, the truths and
#: the normalized error budget
DAYS, POP, REL_TOL = 15, 1e6, 0.30
TRUTH = {"sir": (0.5, 0.2, 1.0), "seir": (0.6, 0.3, 0.2, 1.0)}


# ------------------------------------------------------------------ config
BAD_CONFIGS = [
    dict(wave_loop="sideways"),
    dict(initial_weights=[1.0, 2.0]),
    dict(initial_particles=np.zeros((0, 3))),
    dict(initial_particles=np.zeros((3,))),
    dict(initial_particles=np.zeros((3, 2)), initial_weights=[1.0, 2.0]),
    dict(initial_particles=np.zeros((2, 2)), initial_weights=[1.0, -2.0]),
    dict(initial_particles=np.zeros((2, 2)), initial_weights=[0.0, 0.0]),
    dict(initial_particles=np.zeros((2, 2)), initial_weights=[1.0, np.nan]),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=range(len(BAD_CONFIGS)))
def test_smc_config_errors_are_repros(kw):
    with pytest.raises(ValueError) as theirs:
        jsmc.SMCConfig(**kw)
    with pytest.raises(ValueError) as mine:
        tsmc.SMCConfig(**kw)
    assert str(mine.value) == str(theirs.value)


def test_smc_config_takes_the_cuda_backend_only():
    assert tsmc.SMCConfig().backend == "cuda"
    with pytest.raises(ValueError, match="'cuda' backend only"):
        tsmc.SMCConfig(backend="xla_fused")
    assert not hasattr(tsmc.SMCConfig(), "interpret")


# ---------------------------------------------------------------- formulas
def _population(seed, n=64, p=5, pinned=()):
    rng = np.random.default_rng(seed)
    lows = rng.uniform(0.0, 0.5, p)
    highs = lows + rng.uniform(0.5, 2.0, p)
    for j in pinned:
        highs[j] = lows[j]
    particles = rng.uniform(lows, highs, (n, p)).astype(np.float32)
    new = rng.uniform(lows - 0.05, highs + 0.05, (n, p)).astype(np.float32)  # some outside
    for j in pinned:
        particles[:, j] = new[:, j] = np.float32(lows[j])
    weights = rng.uniform(0.1, 1.0, n)
    return lows, highs, particles, new, weights / weights.sum()


def _repro_weight_update(new_theta, particles, weights, sigma, free, prior):
    """tests' copy of src/repro/core/smc.py:406-418, with repro's log_pdf."""
    denom_sig = np.where(free, sigma, 1.0)
    diff = (new_theta[:, None, :] - particles[None, :, :]) / denom_sig[None, None, :]
    log_k = -0.5 * np.sum(diff * diff, axis=-1)
    log_k -= np.sum(np.log(sigma[free]))
    mx = log_k.max(axis=1, keepdims=True)
    denom = (weights[None, :] * np.exp(log_k - mx)).sum(axis=1)
    log_prior = np.asarray(prior.log_pdf(jnp.asarray(new_theta)))
    w = np.exp(log_prior - (np.log(denom) + mx[:, 0]))
    w = np.where(np.isfinite(w), w, 0.0)
    return w / w.sum() if w.sum() > 0 else np.full_like(w, 1.0 / len(w))


@pytest.mark.parametrize("seed,pinned", [(0, ()), (1, (2,)), (2, (0, 4))])
def test_weighted_var_and_weight_update_equal_repros(seed, pinned):
    lows, highs, particles, new, weights = _population(seed, pinned=pinned)
    np.testing.assert_allclose(tsmc._weighted_var(particles, weights),
                               jsmc._weighted_var(particles, weights), rtol=1e-12)
    mine_prior = UniformBoxPrior(highs=tuple(highs), lows=tuple(lows))
    their_prior = JaxBoxPrior(highs=tuple(highs), lows=tuple(lows))
    free = np.asarray(mine_prior.free_dims(), bool)
    sigma = np.sqrt(2.0 * tsmc._weighted_var(particles, weights))
    sigma = np.where(free, sigma, 0.0).astype(np.float32)
    got = tsmc.importance_weights(new, particles, weights, sigma, free, mine_prior)
    want = _repro_weight_update(new, particles, weights, sigma, free, their_prior)
    assert (want == 0).any() and (want > 0).any()  # some proposals lie outside the box
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_free_dims_equal_repros():
    for tv, sched in (("beta", None),
                      ("beta", ((4,), (0.3,))),  # one pinned scale
                      ("beta", ((3, 8), None))):  # two inferred windows
        mine_s = theirs_s = None
        if sched is not None:
            bps, scales = sched
            if scales is None:
                mine_s = InterventionSchedule.inferred((tv,), bps, 0.2, 1.5)
                theirs_s = JaxSchedule.inferred((tv,), bps, 0.2, 1.5)
            else:
                mine_s = InterventionSchedule.fixed((tv,), bps, scales)
                theirs_s = JaxSchedule.fixed((tv,), bps, scales)
        mine = schedule_prior(get_model("sir"), mine_s).free_dims()
        theirs = jax_schedule_prior(jax_get_model("sir"), theirs_s).free_dims()
        assert mine == theirs
    assert UniformBoxPrior(highs=(1.0, 0.0, 2.0), lows=(0.0, 0.0, 2.0)).free_dims() == (
        True, False, False)


# ----------------------------------------------------------------- runs
def _small_cfg(wave_loop, **kw):
    base = dict(n_particles=32, batch_size=1024, n_rounds=2, quantile=0.5, num_days=10,
                model="sir", wave_loop=wave_loop, max_waves_per_round=20)
    base.update(kw)
    return tsmc.SMCConfig(**base)


@pytest.mark.parametrize("wave_loop", ["host", "device"])
def test_pinned_scale_dimensions_are_never_perturbed(wave_loop):
    sched = InterventionSchedule.fixed(("beta",), (5,), (0.3,))
    ds = get_dataset("synthetic_small", num_days=10, model="sir")
    post = tsmc.run_smc_abc(ds, _small_cfg(wave_loop, schedule=sched), seed=3, device="cpu")
    assert post.param_names[-1] == "beta_w1"
    assert (post.theta[:, -1] == np.float32(0.3)).all()
    box = schedule_prior(get_model("sir"), sched)
    assert ((post.theta >= np.asarray(box.lows, np.float32))
            & (post.theta <= np.asarray(box.highs, np.float32))).all()


@pytest.mark.parametrize("wave_loop", ["host", "device"])
def test_warm_start_resimulates_n_particles(wave_loop):
    ds = get_dataset("synthetic_small", num_days=10, model="sir")
    cold = tsmc.run_smc_abc(ds, _small_cfg(wave_loop), seed=4, device="cpu")
    calls = ref.CALLS
    warm = tsmc.run_smc_abc(
        ds, _small_cfg(wave_loop, n_rounds=1, initial_particles=cold.theta,
                       initial_weights=cold.weights), seed=5, device="cpu")
    assert warm.simulations == 32 + 1024 * warm.round_waves[0]
    assert ref.CALLS - calls == 1 + warm.round_waves[0]
    assert cold.simulations == 1024 * (1 + sum(cold.round_waves))
    with pytest.raises(ValueError, match="initial_particles have width 2"):
        tsmc.run_smc_abc(ds, _small_cfg(wave_loop, initial_particles=np.zeros((4, 2))),
                         device="cpu")


@pytest.mark.parametrize("wave_loop", ["host", "device"])
def test_smc_is_deterministic_and_its_tolerance_falls(wave_loop):
    ds = get_dataset("synthetic_small", num_days=10, model="sir")
    a = tsmc.run_smc_abc(ds, _small_cfg(wave_loop, n_rounds=3), seed=6, device="cpu")
    b = tsmc.run_smc_abc(ds, _small_cfg(wave_loop, n_rounds=3), seed=6, device="cpu")
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert all(x > y for x, y in zip(a.round_eps, a.round_eps[1:]))
    assert len(a) == 32 and np.isfinite(a.distances).all()
    np.testing.assert_allclose(a.weights.sum(), 1.0, rtol=1e-5)


def test_device_round_keeps_accepted_rows_in_the_box_at_or_below_eps():
    """make_smc_round_fn on the CPU: every returned row lies in the box at a
    distance at or below eps (in float32), one sync a segment, and a
    gated wave makes no plain-version call."""
    spec = get_model("sir")
    ds = get_dataset("synthetic_small", num_days=10, model="sir")
    cfg = _small_cfg("device", n_particles=40)
    prior = spec.prior()
    sim = tabc.make_simulator(ds, tabc.ABCConfig(batch_size=1024, chunk_size=1024, num_days=10,
                                                 model="sir", tolerance=np.inf), "cpu")
    round_fn = tsmc.make_smc_round_fn(sim, prior, cfg)
    rng = np.random.default_rng(0)
    particles = prior.sample(1, 64).numpy()
    weights = rng.uniform(0.0, 1.0, 64)
    weights[::3] = 0.0  # zero-weight particles are never parents
    weights /= weights.sum()
    sigma = np.full(3, 0.05, np.float32)
    d_all = sim(torch.from_numpy(particles), 1).numpy()
    eps = float(np.quantile(d_all, 0.5))
    syncs, calls = tabc.HOST_SYNCS, ref.CALLS
    th, d, accepted, waves = round_fn(9, 1, particles, weights, sigma, eps, 20)
    assert th.shape == (min(accepted, 40), 3) and accepted >= 40
    assert tabc.HOST_SYNCS - syncs == -(-waves // tabc.SEGMENT_WAVES)
    assert ref.CALLS - calls == waves
    assert (d <= np.float32(eps)).all() and np.isfinite(d).all()
    lo, hi = np.asarray(prior.lows, np.float32), np.asarray(prior.highs, np.float32)
    assert ((th >= lo) & (th <= hi)).all()
    again = round_fn(9, 1, particles, weights, sigma, eps, 20)
    np.testing.assert_array_equal(th, again[0])


# -------------------------------------------------------------- recovery
@pytest.mark.parametrize("model", ["sir", "seir"])
@pytest.mark.parametrize("wave_loop", ["host", "device"])
def test_run_smc_abc_recovers_truth(model, wave_loop):
    """tests/test_posterior_recovery.py:89-102 on the port, on repro's own
    recovery series (threefry, `synthetic_dataset(seed=11)`) as numpy
    arrays: every parameter's posterior mean within REL_TOL of the prior
    width of the truth, and closer on average than the prior mean."""
    jds = jax_synthetic_dataset(theta=TRUTH[model], population=POP, num_days=DAYS, a0=100.0,
                                seed=11, name=f"recovery_{model}", model=model)
    ds = convert.country_data_from_arrays(jds.name, jds.population, jds.a0, jds.r0, jds.d0,
                                          jds.observed, true_theta=TRUTH[model], model=model)
    cfg = tsmc.SMCConfig(n_particles=96, batch_size=4096, n_rounds=3, quantile=0.4,
                         num_days=DAYS, model=model, wave_loop=wave_loop)
    post = tsmc.run_smc_abc(ds, cfg, seed=1, device="cpu")
    assert len(post) == 96
    assert np.isfinite(post.distances).all()
    prior = get_model(model).prior()
    lo, hi = np.asarray(prior.lows), np.asarray(prior.highs)
    truth = np.asarray(TRUTH[model])
    err = np.abs(post.theta.mean(axis=0) - truth) / (hi - lo)
    assert (err <= REL_TOL).all(), (model, err, post.theta.mean(axis=0))
    assert err.mean() < (np.abs((hi + lo) / 2 - truth) / (hi - lo)).mean()
