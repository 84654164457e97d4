"""The port's serving CLIs on the CPU: tests/check_epi_serve.py's smoke
through `repro_torch.launch.abc_serve` and `repro_torch.launch.serve --epi`,
and `abc_run --forecast` against `forecast_bands`.

A toy sir dataset file is fitted by one `abc_serve --once` sweep (one cold
fit); `serve --epi` then answers 8 forecast and counterfactual queries from
the store: strict-JSON bands of FIT_DAYS + HORIZON days that do not cross,
no fit on the query path, at most 2 batched calls. The card runs the same
commands in `chip_smoke.py` (phase `epi_serve`, part d).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core.posterior import Posterior
from repro_torch.core.serving import forecast_bands, save_dataset_file
from repro_torch.epi.data import get_dataset, synthetic_dataset
from repro_torch.launch import abc_run, abc_serve, serve

torch.set_num_threads(1)

#: tests/check_epi_serve.py's sizes
FIT_DAYS = 8
HORIZON = 6
FIT_ARGS = ["--days", str(FIT_DAYS), "--fit-particles", "16", "--fit-batch", "256",
            "--fit-rounds", "1", "--device", "cpu"]


def _strict_loads(text: str):
    def refuse(token):
        raise AssertionError(f"non-strict JSON token {token!r} in response")

    return json.loads(text, parse_constant=refuse)


def _check_bands(resp: dict, fit_days: int, total: int) -> None:
    assert resp["total_days"] == total and resp["fit_days"] == fit_days
    assert resp["channels"], "no channels in response"
    for name, bands in resp["channels"].items():
        for key in ("mean", "q05", "q25", "q50", "q75", "q95"):
            vals = bands[key]
            assert len(vals) == total, (name, key, len(vals))
            assert all(np.isfinite(vals)), (name, key)
        lo, mid, hi = (np.asarray(bands[k]) for k in ("q05", "q50", "q95"))
        assert (lo <= mid).all() and (mid <= hi).all(), f"{name}: quantile bands cross"
    assert len(resp["observed"]) == len(resp["channels"])
    for vals in resp["observed"].values():
        assert len(vals) == fit_days


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One cold fit by the daemon, then 8 queries answered from the store."""
    tmp = tmp_path_factory.mktemp("epi_serve")
    data_dir, store, out = tmp / "data", tmp / "store", tmp / "responses.json"
    data_dir.mkdir()
    save_dataset_file(str(data_dir / "toy.json"), synthetic_dataset(
        theta=(0.5, 0.2, 1.0), population=1e6, num_days=12, a0=100.0, seed=11, name="toy",
        model="sir"))
    queries = ([{"dataset": "toy", "model": "sir", "horizon": HORIZON, "seed": s}
                for s in range(4)]
               + [{"dataset": "toy", "model": "sir", "horizon": HORIZON, "seed": s,
                   "schedule": "beta@4=0.5"} for s in range(4)])
    (tmp / "queries.json").write_text(json.dumps({"queries": queries}))
    daemon = ["--once", "--data-dir", str(data_dir), "--store", str(store), "--models", "sir"]
    refits = abc_serve.main(daemon + FIT_ARGS)
    answered = serve.main(["--epi", "--queries", str(tmp / "queries.json"), "--data-dir",
                           str(data_dir), "--store", str(store), "--out", str(out),
                           "--slots", "4", "--particles", "16"] + FIT_ARGS)
    again = abc_serve.main(daemon + FIT_ARGS)
    return refits, answered, again, _strict_loads(out.read_text())


def test_daemon_fits_once_then_finds_the_store_fresh(served):
    refits, _, again, _ = served
    assert refits == 1  # one cold fit
    assert again == 0  # content unchanged: cached


def test_serve_epi_answers_every_query_from_the_store(served):
    _, answered, _, payload = served
    responses, stats = payload["responses"], payload["stats"]
    assert answered == len(responses) == 8
    assert stats["fits"] == 0, stats
    assert stats["batched_calls"] <= 2, stats
    assert stats["compiled_shapes"] == 2, stats


@pytest.mark.parametrize("i", range(8))
def test_each_response_holds_bands_that_do_not_cross(served, i):
    resp = served[3]["responses"][i]
    _check_bands(resp, FIT_DAYS, FIT_DAYS + HORIZON)
    assert (resp["schedule"] is None) == (i < 4)
    assert resp["model"] == "sir" and resp["dataset"] == "toy"


def test_serve_epi_refuses_what_repro_refuses(tmp_path):
    with pytest.raises(SystemExit, match="--queries"):
        serve.main(["--epi", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--epi", "--arch", "gemma-2b", "--queries", "q.json"])
    (tmp_path / "empty.json").write_text("[]")
    with pytest.raises(SystemExit, match="non-empty"):
        serve.main(["--epi", "--queries", str(tmp_path / "empty.json"), "--device", "cpu"])


@pytest.mark.parametrize("schedule", ["", "alpha0@4=0.5", "none"])
def test_abc_run_forecast_equals_forecast_bands(tmp_path, schedule):
    """`abc_run --forecast` on the CPU, under a fit schedule, writes bands
    equal to `forecast_bands` called directly on its posterior (seed
    --seed + 1, the fit schedule unless --forecast-schedule)."""
    post_path, out = tmp_path / "post.npz", tmp_path / "bands.json"
    argv = ["--device", "cpu", "--dataset", "synthetic_small", "--days", "10", "--batch",
            "1024", "--chunk", "256", "--auto-tolerance", "0.05", "--accept", "10",
            "--max-runs", "5", "--intervention", "alpha0@5=0:2", "--seed", "3",
            "--save-posterior", str(post_path), "--forecast", "4", "--forecast-out", str(out)]
    if schedule:
        argv += ["--forecast-schedule", schedule]
    post = abc_run.main(argv)
    bands = _strict_loads(out.read_text())
    fit_sched = abc_run.parse_intervention("alpha0@5=0:2")
    fc = None if not schedule else (abc_run.parse_intervention(schedule)
                                    or abc_run.EMPTY_SCHEDULE)
    want = forecast_bands(Posterior.load(str(post_path)).theta,
                          get_dataset("synthetic_small", num_days=10), model="siard",
                          fit_days=10, horizon=4, fit_schedule=fit_sched, schedule=fc, key=4,
                          device="cpu")
    assert bands == want
    _check_bands(bands, 10, 14)
    assert bands["n_particles"] == len(post)
    assert (bands["schedule"] is None) == (schedule == "none")
