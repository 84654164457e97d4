"""The port's NPE backend end to end on the CPU: recovery, `repro`'s ABC
oracle, determinism, serving and the CLIs.

  * `run_abc(backend="npe")` on `repro`'s own recovery series (threefry,
    `tests/test_posterior_recovery.py`'s truth, population, days and seed,
    taken as arrays through `convert.country_data_from_arrays`) meets that
    file's bars: the posterior mean within REL_TOL = 0.30 of the prior
    width of the truth and nearer than the prior mean; against `repro`'s own
    `xla_fused` ABC oracle posterior, the means within ORACLE_DRIFT = 0.25
    of the prior width and overlapping 90% intervals on every parameter.
  * The same seed gives the same bits on the CPU: the estimator's weights
    and the draws.
  * NPE serving (`tests/test_npe.py:195-277`): a query, and a query after
    the dataset's content moved, enter no wave fitter (`run_smc_abc` is
    patched to fail) and call no plain version of the `abc_sim` kernel; the
    estimator persists across servers.
  * `abc_run --backend npe`, `abc_serve --once --backend npe` and
    `serve --epi --backend npe` with `--device cpu`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import test_posterior_recovery as rec
from repro.epi.data import synthetic_dataset as jax_synthetic_dataset
from repro_torch import convert
from repro_torch.core import npe as tnpe
from repro_torch.core import serving
from repro_torch.core.abc import ABCConfig, run_abc
from repro_torch.core.npe import NPEConfig, train_npe
from repro_torch.core.serving import EpiServer, ForecastQuery, ServeConfig, save_dataset_file
from repro_torch.core.smc import SMCConfig
from repro_torch.epi.models import get_model
from repro_torch.kernels import abc_sim, ref
from repro_torch.launch import abc_run, abc_serve, serve
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)

#: tests/test_posterior_recovery.py's estimator budget, as the port's config
NPE_TEST = NPEConfig(**dataclasses.asdict(rec.NPE_TEST))
DAYS = rec.DAYS


def _port_dataset(model, jds=None, scale=1.0, name=None):
    jds = jds if jds is not None else rec._dataset(model)
    return convert.country_data_from_arrays(
        name or jds.name, jds.population, jds.a0, jds.r0, jds.d0,
        (np.asarray(jds.observed) * scale).astype(np.float32), true_theta=jds.true_theta,
        model=model)


@pytest.mark.parametrize("model", ["sir", "seir"])
def test_npe_recovers_truth_and_agrees_with_abc_oracle(model):
    """backend='npe' through run_abc: tests/test_posterior_recovery.py:127-175
    with the port's estimator and repro's ABC oracle."""
    jds = rec._dataset(model)
    ds = _port_dataset(model, jds)
    cfg = ABCConfig(num_days=DAYS, backend="npe", model=model, target_accepted=256,
                    npe=NPE_TEST)
    npe_post = run_abc(ds, cfg, seed=0, device="cpu")
    assert npe_post.runs == 0 and npe_post.tolerance == 0.0
    assert npe_post.theta.shape == (256, len(rec.TRUTH[model]))
    assert np.isfinite(npe_post.distances).all()
    assert npe_post.simulations == NPE_TEST.n_pilot + NPE_TEST.train_steps * NPE_TEST.train_batch
    rec._assert_recovers(npe_post.theta, model)

    abc_post = rec._abc_oracle(model, jds)
    spec = get_model(model)
    width = np.asarray(spec.prior().highs, np.float32) - np.asarray(spec.prior().lows,
                                                                     np.float32)
    drift = np.abs(npe_post.theta.mean(axis=0) - abc_post.theta.mean(axis=0)) / width
    assert (drift <= rec.ORACLE_DRIFT).all(), (model, drift)
    for j, name in enumerate(npe_post.param_names):
        npe_lo, npe_hi = np.quantile(npe_post.theta[:, j], [0.05, 0.95])
        abc_lo, abc_hi = np.quantile(abc_post.theta[:, j], [0.05, 0.95])
        assert min(npe_hi, abc_hi) - max(npe_lo, abc_lo) > 0.0, (
            f"{model}.{name}: npe [{npe_lo:.4f}, {npe_hi:.4f}] vs "
            f"abc [{abc_lo:.4f}, {abc_hi:.4f}]")


def test_npe_fixed_seed_is_deterministic():
    """The same seed reproduces the posterior bit for bit on the CPU (the
    estimator's weights and the mixture draws); another seed moves it."""
    ds = _port_dataset("sir")
    tiny = ABCConfig(num_days=DAYS, backend="npe", model="sir", target_accepted=64,
                     npe=NPEConfig(train_steps=30, train_batch=64, n_pilot=64, hidden=32))
    a = run_abc(ds, tiny, seed=7, device="cpu")
    b = run_abc(ds, tiny, seed=7, device="cpu")
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.distances, b.distances)
    e1 = train_npe(ds, tiny, seed=7, device="cpu")
    e2 = train_npe(ds, tiny, seed=7, device="cpu")
    for l1, l2 in zip(tree_leaves(e1.params), tree_leaves(e2.params)):
        assert torch.equal(l1, l2)
    assert e1.final_loss == e2.final_loss
    np.testing.assert_array_equal(e1.feat_mean, e2.feat_mean)
    c = run_abc(ds, tiny, seed=8, device="cpu")
    assert not np.array_equal(a.theta, c.theta)


# ----------------------------------------------------------------- serving
SERVE_TINY = NPEConfig(train_steps=25, train_batch=64, n_pilot=64, hidden=32,
                       n_components=3, fine_tune_steps=4)
SERVE_DAYS = 12


def _served(scale=1.0):
    jds = jax_synthetic_dataset(theta=(0.5, 0.2, 1.0), population=1e6,
                                num_days=SERVE_DAYS, a0=100.0, seed=3, name="served",
                                model="sir")
    return _port_dataset("sir", jds, scale)


def _serve_cfg(tmp_path, particles=48, npe=SERVE_TINY):
    return ServeConfig(
        slots=2, forecast_particles=16,
        fit=SMCConfig(n_particles=particles, batch_size=512, n_rounds=2, quantile=0.5,
                      num_days=SERVE_DAYS, model="sir", wave_loop="device"),
        data_dir=str(tmp_path / "data"), store_dir=str(tmp_path / "store"),
        fit_backend="npe", npe=npe,
    )


@pytest.fixture
def no_waves(monkeypatch):
    """Any wave fit fails at once; the plain abc_sim calls and the card's
    launches are read before and after."""
    def _no_waves(*a, **k):
        raise AssertionError("NPE serving path entered the SMC wave fitter")

    monkeypatch.setattr(serving, "run_smc_abc", _no_waves)
    return lambda: (ref.CALLS, dict(abc_sim.ENTRY_LAUNCHES))


def test_serving_npe_query_runs_zero_simulation_waves(tmp_path, no_waves):
    (tmp_path / "data").mkdir()
    save_dataset_file(str(tmp_path / "data" / "served.json"), _served())
    before = no_waves()
    server = EpiServer(_serve_cfg(tmp_path, npe=dataclasses.replace(SERVE_TINY,
                                                                    fine_tune_steps=0)),
                       device="cpu")
    q = ForecastQuery(dataset="served", model="sir", horizon=4)
    (resp,) = server.answer([q])
    assert resp["total_days"] == SERVE_DAYS + 4
    stats = server.stats()
    assert stats["fits"] == 0 and stats["npe_trains"] == 1 and stats["npe_fine_tunes"] == 0
    post, _ = server.get_posterior("served", "sir")
    assert post.runs == 0 and len(post) == 48
    train_sims = post.simulations

    # the dataset's content moves: the refresh runs no wave and no simulation
    save_dataset_file(str(tmp_path / "data" / "served.json"), _served(scale=1.1))
    assert server.refresh("served", "sir") == "warm_refit"
    stats = server.stats()
    assert stats["fits"] == 0 and stats["npe_fine_tunes"] == 1
    post2, _ = server.get_posterior("served", "sir")
    assert post2.simulations == train_sims  # fine_tune_steps=0: a free refresh
    assert not np.array_equal(post.theta, post2.theta)  # conditions on the new series
    assert no_waves() == before


def test_serving_npe_estimator_persists_across_servers(tmp_path, no_waves):
    (tmp_path / "data").mkdir()
    save_dataset_file(str(tmp_path / "data" / "served.json"), _served())
    cfg = _serve_cfg(tmp_path, particles=32)
    before = no_waves()
    s1 = EpiServer(cfg, device="cpu")
    assert s1.refresh("served", "sir") == "cold_fit"
    est_dir = tmp_path / "store" / "npe"
    assert len(os.listdir(est_dir)) == 1

    s2 = EpiServer(cfg, device="cpu")
    assert s2.refresh("served", "sir") == "cached"
    assert s2.stats()["npe_trains"] == 0 and s2.stats()["fits"] == 0

    # the content moves: a new server fine-tunes the estimator on disk
    save_dataset_file(str(tmp_path / "data" / "served.json"), _served(scale=1.2))
    s3 = EpiServer(cfg, device="cpu")
    assert s3.refresh("served", "sir") == "warm_refit"
    assert s3.stats()["npe_trains"] == 0 and s3.stats()["npe_fine_tunes"] == 1
    post, _ = s3.get_posterior("served", "sir")
    assert post.simulations == (SERVE_TINY.n_pilot + 25 * 64
                                + SERVE_TINY.fine_tune_steps * SERVE_TINY.train_batch)
    # the fine-tuned estimator replaced the file
    back = tnpe.NPEstimator.load(str(est_dir / os.listdir(est_dir)[0]), device="cpu")
    assert back.train_steps_done == 25 + SERVE_TINY.fine_tune_steps
    assert no_waves() == before


def test_npe_serving_config_mirrors_the_smc_template():
    """The estimator is trained for the SMC template's model, window,
    summary, distance and schedule, and samples its particle count."""
    cfg = ServeConfig(fit=SMCConfig(n_particles=40, num_days=9, model="siard",
                                    summary="log_weekly", distance="mae"),
                      fit_backend="npe", npe=SERVE_TINY)
    server = EpiServer(cfg, device="cpu")
    abc = server._npe_train_cfg("sir")
    assert (abc.backend, abc.model, abc.num_days, abc.summary, abc.distance,
            abc.target_accepted, abc.npe) == ("npe", "sir", 9, "log_weekly", "mae", 40,
                                              SERVE_TINY)
    assert server._estimator_path("k") is None


# --------------------------------------------------------------------- CLIs
NPE_FLAGS = ["--npe-steps", "25", "--npe-batch", "64", "--npe-hidden", "32",
             "--npe-components", "3"]


def test_abc_run_backend_npe_on_the_cpu(capsys):
    post = abc_run.main(["--backend", "npe", "--device", "cpu", "--model", "sir",
                         "--dataset", "synthetic_small", "--days", str(SERVE_DAYS),
                         "--accept", "32", *NPE_FLAGS])
    assert post.runs == 0 and len(post) == 32 and post.tolerance == 0.0
    assert post.simulations == 512 + 25 * 64
    assert "beta" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--backend", "npe", "--auto-tolerance", "0.05"], "auto-tolerance"),
    (["--backend", "npe", "--state", "s.npz"], "state"),
    (["--npe-steps", "3"], "without --backend npe"),
    (["--backend", "npe", "--campaign"], "campaign"),
])
def test_abc_run_refuses_what_npe_does_not_take(argv, match, capsys):
    with pytest.raises(SystemExit):
        abc_run.main(["--device", "cpu", "--model", "sir", *argv])
    assert match in capsys.readouterr().err


def test_abc_serve_and_serve_backend_npe_on_the_cpu(tmp_path, monkeypatch, capsys):
    """abc_serve --once --backend npe: 1 cold fit, a content change 1 warm
    re-fit (the estimator fine-tuned from disk), then 0; serve --epi
    --backend npe then answers from that store with no training."""
    data, store = tmp_path / "data", tmp_path / "store"
    data.mkdir()
    save_dataset_file(str(data / "served.json"), _served())
    monkeypatch.setattr(serving, "run_smc_abc", None)  # a wave fit would fail
    argv = ["--once", "--device", "cpu", "--data-dir", str(data), "--store", str(store),
            "--models", "sir", "--days", str(SERVE_DAYS), "--fit-particles", "16",
            "--backend", "npe", "--npe-steps", "25", "--npe-fine-tune", "2"]
    assert abc_serve.main(argv) == 1
    assert len(os.listdir(store / "npe")) == 1
    save_dataset_file(str(data / "served.json"), _served(scale=1.1))
    assert abc_serve.main(argv) == 1
    assert "warm_refit" in capsys.readouterr().err
    assert abc_serve.main(argv) == 0
    with pytest.raises(SystemExit):
        abc_serve.main(argv[:-6] + ["--npe-steps", "3"])
    assert "without --backend npe" in capsys.readouterr().err

    queries = tmp_path / "q.json"
    queries.write_text(json.dumps([{"dataset": "served", "model": "sir", "horizon": 3}]))
    out = tmp_path / "r.json"
    assert serve.main(["--epi", "--device", "cpu", "--queries", str(queries),
                       "--data-dir", str(data), "--store", str(store), "--days",
                       str(SERVE_DAYS), "--fit-particles", "16", "--particles", "16",
                       "--backend", "npe", "--out", str(out)]) == 1
    payload = json.loads(out.read_text())
    assert payload["stats"]["npe_trains"] == payload["stats"]["fits"] == 0
    assert payload["responses"][0]["total_days"] == SERVE_DAYS + 3
