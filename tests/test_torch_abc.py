"""The port's ABC slice as a whole, held against `repro` on the CPU.

Datasets come from `repro` and cross into the port as numpy arrays
(`repro_torch.convert`), so both packages fit one series. The port runs its
plain PyTorch path here (`device="cpu"`); the card runs the CUDA kernel
(tests/test_torch_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abc as jabc
from repro.core.posterior import Posterior as JaxPosterior
from repro.core.priors import paper_prior as jax_paper_prior
from repro.epi.data import get_dataset as jax_get_dataset
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import abc as tabc
from repro_torch.core.posterior import Posterior
from repro_torch.epi.models import get_model
from repro_torch.launch import abc_run

torch.set_num_threads(1)

BAR = dict(rtol=2e-6, atol=1e-3)
COUNTRY_BAR = dict(rtol=1e-5, atol=1.0)


def _port_dataset(name: str, days: int):
    ds = jax_get_dataset(name, num_days=days)
    return ds, convert.country_data_from_arrays(
        ds.name, ds.population, ds.a0, ds.r0, ds.d0, ds.observed,
        true_theta=ds.true_theta, paper_tolerance=ds.paper_tolerance)


@pytest.mark.parametrize("name,days,bar", [("synthetic_small", 49, BAR),
                                           ("italy", 49, COUNTRY_BAR)])
def test_make_simulator_matches_repro_oracle(name, days, bar):
    jds, tds = _port_dataset(name, days)
    theta = np.asarray(jax_paper_prior().sample(jax.random.PRNGKey(1), (512,)))
    cfg = tabc.ABCConfig(batch_size=512, chunk_size=512, num_days=days)
    got = tabc.make_simulator(tds, cfg, device="cpu")(torch.from_numpy(theta), 21)

    def oracle(th, ob, pop, a0, r0, d0):
        return jref.abc_sim_distance_ref(th, jnp.uint32(21), ob, population=pop,
                                         a0=a0, r0=r0, d0=d0)

    # dataset scalars as run-time values, as the kernels read them (see
    # tests/test_torch_abc_sim.py)
    want = jax.jit(oracle)(jnp.asarray(theta), jnp.asarray(jds.observed),
                           *[jnp.float32(v) for v in (jds.population, jds.a0,
                                                      jds.r0, jds.d0)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **bar)


def _small_cfg(**kw):
    base = dict(batch_size=1024, chunk_size=256, tolerance=2500.0,
                target_accepted=10_000, max_runs=4, num_days=12)
    base.update(kw)
    return tabc.ABCConfig(**base)


@pytest.fixture(scope="module")
def small():
    return _port_dataset("synthetic_small", 12)[1]


def test_same_seed_gives_bitwise_same_accepted_set(small):
    a = tabc.run_abc(small, _small_cfg(), seed=5, device="cpu")
    b = tabc.run_abc(small, _small_cfg(), seed=5, device="cpu")
    c = tabc.run_abc(small, _small_cfg(), seed=6, device="cpu")
    assert len(a) > 0 and a.runs == 4 and a.simulations == 4 * 1024
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.distances, b.distances)
    assert not np.array_equal(a.theta[:5], c.theta[:5])
    assert (a.distances <= 2500.0).all()


def test_resume_from_mid_run_state_equals_uninterrupted(small, tmp_path):
    full = tabc.run_abc(small, _small_cfg(), seed=3, device="cpu")
    state = tabc.ABCState()
    tabc.run_abc(small, _small_cfg(max_runs=2), seed=3, state=state, device="cpu")
    path = tmp_path / "state.npz"
    state.save(str(path))
    resumed = tabc.run_abc(small, _small_cfg(), seed=3,
                           state=tabc.ABCState.load(str(path)), device="cpu")
    assert resumed.runs == full.runs
    np.testing.assert_array_equal(resumed.theta, full.theta)
    np.testing.assert_array_equal(resumed.distances, full.distances)


def test_topk_strategy_keeps_at_most_k_per_wave(small):
    post = tabc.run_abc(small, _small_cfg(strategy="topk", top_k=3,
                                          tolerance=1e9), seed=1, device="cpu")
    assert len(post) == 3 * 4
    assert (np.diff(post.distances.reshape(4, 3), axis=1) >= 0).all()


def test_abc_state_and_posterior_files_cross_both_ways(small, tmp_path):
    # a fit started in repro resumes in the port
    jstate = jabc.ABCState(run_idx=2, simulations=2048, n_params=8)
    jstate.accepted_theta = [np.full((3, 8), 0.5, np.float32)]
    jstate.accepted_dist = [np.arange(3, dtype=np.float32)]
    jstate.save(str(tmp_path / "j.npz"))
    st = convert.load_npz(str(tmp_path / "j.npz"))
    assert isinstance(st, tabc.ABCState)
    assert (st.run_idx, st.simulations, st.n_accepted) == (2, 2048, 3)
    post = tabc.run_abc(small, _small_cfg(), seed=3, state=st, device="cpu")
    assert post.runs == 4 and post.simulations == 4 * 1024
    np.testing.assert_array_equal(post.theta[:3], jstate.accepted_theta[0])
    # and the port's files load in repro
    st.save(str(tmp_path / "t.npz"))
    back = jabc.ABCState.load(str(tmp_path / "t.npz"))
    assert (back.run_idx, back.simulations, back.n_accepted) == (4, 4096, st.n_accepted)
    post.save(str(tmp_path / "p.npz"))
    jp = JaxPosterior.load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(jp.theta, post.theta)
    assert list(jp.param_names) == list(post.param_names)
    jp.save(str(tmp_path / "q.npz"))
    tp = convert.load_npz(str(tmp_path / "q.npz"))
    assert isinstance(tp, Posterior) and tp.runs == post.runs
    np.testing.assert_array_equal(tp.distances, post.distances)


def test_prior_matches_repro_box_semantics():
    from repro_torch.core.priors import paper_prior

    prior, jprior = paper_prior(), jax_paper_prior()
    theta = prior.sample(11, 4096)
    assert theta.shape == (4096, 8) and theta.dtype == torch.float32
    assert torch.equal(theta, prior.sample(11, 4096))
    lo, hi = np.asarray(jprior.lows, np.float32), np.asarray(jprior.highs, np.float32)
    assert (theta.numpy() >= lo).all() and (theta.numpy() <= hi).all()
    assert np.allclose(theta.numpy().mean(0), (lo + hi) / 2, rtol=0.05)
    probe = np.concatenate([theta.numpy()[:4], (hi * 1.5)[None], -hi[None]])
    np.testing.assert_allclose(prior.log_pdf(torch.from_numpy(probe)).numpy(),
                               np.asarray(jprior.log_pdf(jnp.asarray(probe))), rtol=1e-6)
    np.testing.assert_array_equal(prior.clip(torch.from_numpy(probe)).numpy(),
                                  np.asarray(jprior.clip(jnp.asarray(probe))))


def _normalized_error(theta: np.ndarray, truth) -> float:
    highs = np.asarray(jax_paper_prior().highs)
    return float((np.abs(theta.mean(axis=0) - np.asarray(truth)) / highs).mean())


def test_siard_posterior_no_worse_than_repro_xla_fused():
    """Normalized posterior-mean error (tests/test_posterior_recovery.py:60-72)
    on repro's synthetic_small at 20 days, tolerance at the same pilot
    quantile for both packages."""
    days, quantile = 20, 5e-3
    jds, tds = _port_dataset("synthetic_small", days)
    common = dict(batch_size=4096, chunk_size=4096, num_days=days,
                  target_accepted=200, max_runs=60)
    jcfg = jabc.ABCConfig(backend="xla_fused", tolerance=1.0, **common)
    jeps = jabc.calibrate_tolerance(jds, jcfg, key=0, quantile=quantile,
                                    n_pilot=16384)
    jpost = jabc.run_abc(jds, jabc.ABCConfig(
        backend="xla_fused", tolerance=jeps, wave_loop="host", **common), key=0)
    tcfg = tabc.ABCConfig(tolerance=1.0, **common)
    teps = tabc.calibrate_tolerance(tds, tcfg, seed=0, quantile=quantile,
                                    n_pilot=16384, device="cpu")
    tpost = tabc.run_abc(tds, tabc.ABCConfig(tolerance=teps, **common), seed=0,
                         device="cpu")
    assert len(jpost) >= 200 and len(tpost) >= 200
    assert 0.5 < teps / jeps < 2.0
    truth = jds.true_theta
    t_err, j_err = _normalized_error(tpost.theta, truth), _normalized_error(jpost.theta, truth)
    assert t_err <= j_err + 0.05, (t_err, j_err)


def test_cli_on_cpu_prints_the_posterior_table(capsys, tmp_path):
    out = tmp_path / "post.npz"
    post = abc_run.main(["--device", "cpu", "--dataset", "synthetic_small",
                         "--days", "10", "--batch", "1024", "--chunk", "256",
                         "--auto-tolerance", "0.05", "--accept", "10",
                         "--max-runs", "5", "--save-posterior", str(out)])
    text = capsys.readouterr().out
    assert "auto-calibrated tolerance" in text
    assert "param |" in text and "kappa |" in text and "N=" in text
    assert len(post) >= 10 and Posterior.load(str(out)).theta.shape == post.theta.shape


@pytest.mark.parametrize("strategy", ["outfeed", "topk"])
def test_run_abc_equals_a_hand_written_loop_over_wave_seeds(small, strategy):
    """run_abc on the CPU is prior.sample + make_simulator over wave_seeds,
    NaN never accepted, bit for bit, harvested in sample order (outfeed) or
    the k lowest per wave (top-k)."""
    cfg = _small_cfg(strategy=strategy, top_k=3,
                     tolerance=2500.0 if strategy == "outfeed" else 1e9)
    post = tabc.run_abc(small, cfg, seed=4, device="cpu")
    prior = get_model(cfg.model).prior()
    sim = tabc.make_simulator(small, cfg, device="cpu")
    thetas, dists = [], []
    for i in range(cfg.max_runs):
        prior_seed, sim_seed = tabc.wave_seeds(4, i)
        theta = prior.sample(prior_seed, cfg.batch_size)
        dist = sim(theta, sim_seed)
        dist = torch.where(torch.isnan(dist), torch.full_like(dist, float("inf")), dist)
        if strategy == "topk":
            dist, idx = torch.topk(dist, cfg.top_k, largest=False, sorted=True)
            theta = theta[idx]
        keep = dist <= cfg.tolerance
        thetas.append(theta[keep].numpy())
        dists.append(dist[keep].numpy())
    assert post.runs == cfg.max_runs and len(post) > 0
    np.testing.assert_array_equal(post.theta, np.concatenate(thetas))
    np.testing.assert_array_equal(post.distances, np.concatenate(dists))


def test_calibrate_tolerance_on_the_cpu_is_the_pilot_quantile(small):
    cfg = _small_cfg()
    got = tabc.calibrate_tolerance(small, cfg, seed=2, quantile=0.1, n_pilot=2048,
                                   device="cpu")
    prior = get_model(cfg.model).prior()
    sim = tabc.make_simulator(small, cfg, device="cpu")
    dists = []
    for w in range(2048 // cfg.batch_size):
        theta = prior.sample(tabc.stream_seed(2, w, tabc.PILOT_PRIOR_STREAM), cfg.batch_size)
        d = sim(theta, tabc.stream_seed(2, w, tabc.PILOT_SIM_STREAM)).numpy()
        dists.append(d[np.isfinite(d)])
    assert got == float(np.quantile(np.concatenate(dists), 0.1))
