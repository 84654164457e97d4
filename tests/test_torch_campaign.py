"""The port's campaign runner and checkpointer, held against `repro`.

Mirrors tests/test_campaign.py at its sizes (batch 1024, 10 days, target 6,
quantile 0.02, pilot 1024, max_runs 40, checkpoint_every 8) on the port's
own hash series, on the CPU (`device="cpu"`: the plain version; the card
runs the same loop through the kernel, `chip_smoke.py` phase
`campaign_path`). Each cell is held bitwise to its solo run
(`calibrate_tolerance` + `run_abc` on the device loop); the grids of
tests/test_interventions.py, tests/test_summaries.py and
tests/test_metapop.py share one shape each; names and report keys are
`repro`'s; checkpoints cross between `repro.checkpoint` and
`repro_torch.checkpoint` both ways (the twins of tests/test_checkpoint.py).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import campaign as jcampaign
from repro.core.summaries import SummarySpec as JaxSummarySpec
from repro.epi.spec import InterventionSchedule as JaxSchedule
from repro_torch.checkpoint import Checkpointer, load_checkpoint, save_checkpoint
from repro_torch.core import abc as tabc
from repro_torch.core import campaign as tcampaign
from repro_torch.core.campaign import CampaignConfig, Scenario, run_campaign
from repro_torch.core.summaries import SummarySpec
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule, regionalize
from repro_torch.kernels import ref
from repro_torch.launch import abc_run

torch.set_num_threads(1)

COUNTRIES = ("italy", "new_zealand", "usa")
MODELS = ("siard", "seiard")
#: `repro`'s config fields the port drops (JAX-only knobs) and adds
JAX_ONLY = {"interpret", "tile", "scan_unroll"}
PORT_ONLY = {"block"}


def _cfg(tmp_path, **kw):
    base = dict(
        datasets=COUNTRIES,
        models=MODELS,
        seeds=(0,),
        batch_size=1024,
        num_days=10,
        target_accepted=6,
        auto_quantile=0.02,
        pilot_size=1024,
        max_runs=40,
        out_dir=str(tmp_path / "camp"),
        checkpoint_every=8,
    )
    base.update(kw)
    return CampaignConfig(**base)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _cell_rows(cfg, r):
    """A cell's accepted (theta, distances) from its newest checkpoint."""
    capacity = tabc.wave_capacity(cfg.abc_config(Scenario(r.dataset, r.model), 1.0))
    p = len(r.posterior_mean)
    like = {"theta_buf": np.zeros((capacity, p), np.float32),
            "dist_buf": np.zeros((capacity,), np.float32)}
    tree, meta, _ = load_checkpoint(r.checkpoint_dir, like)
    fill = meta["fill"]
    return tree["theta_buf"][:fill], tree["dist_buf"][:fill]


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """One 3-countries x 2-models campaign shared by the assertions below."""
    cfg = _cfg(tmp_path_factory.mktemp("campaign"))
    return cfg, run_campaign(cfg, device="cpu")


def test_campaign_completes_all_scenarios(campaign):
    cfg, report = campaign
    assert len(report.scenarios) == 6
    for r in report.scenarios:
        assert r.status == "ok", (r.name, r.status, r.detail)
        assert r.backend == "cuda" and r.device == "cpu"
        assert r.n_accepted >= cfg.target_accepted and r.runs >= 1
        assert r.simulations == r.runs * cfg.batch_size
        assert r.posterior_mean and r.posterior_std
        assert len(r.eps_schedule) >= 1 and r.tolerance == r.eps_schedule[-1]


def test_campaign_shares_one_shape_a_model(campaign):
    _, report = campaign
    assert report.compiled_shapes == 2  # 3 countries share each model's entry


def test_campaign_writes_report_and_checkpoints(campaign):
    cfg, report = campaign
    payload = json.loads((Path(cfg.out_dir) / "campaign_report.json").read_text())
    assert len(payload["scenarios"]) == 6 and payload["compiled_shapes"] == 2
    for r in report.scenarios:
        ckpt = Path(r.checkpoint_dir)
        assert ckpt.is_dir() and list(ckpt.glob("step_*")), r.name
    assert "scenario" in report.summary_table()
    assert "6/6 scenarios complete" in report.summary_table()


def test_campaign_resumes_completed_scenarios_without_a_launch(campaign):
    cfg, report = campaign
    calls = ref.CALLS
    report2 = run_campaign(cfg, device="cpu")
    assert ref.CALLS == calls  # no pilot, no wave
    for r, r2 in zip(report.scenarios, report2.scenarios):
        assert r2.status == "resumed_complete", (r2.name, r2.status)
        assert dataclasses.replace(r2, status="ok") == r


@pytest.mark.parametrize("dataset", COUNTRIES)
@pytest.mark.parametrize("model", MODELS)
def test_campaign_cell_equals_its_solo_run(campaign, dataset, model):
    """A cell is the same inference, bitwise, as calibrate_tolerance +
    run_abc with its seed and quantile on the device loop."""
    cfg, report = campaign
    r = next(s for s in report.scenarios if (s.dataset, s.model) == (dataset, model))
    ds = get_dataset(dataset, num_days=cfg.num_days, model=model)
    solo_cfg = tabc.ABCConfig(
        batch_size=cfg.batch_size, tolerance=1.0, target_accepted=cfg.target_accepted,
        strategy="outfeed", chunk_size=cfg.batch_size, max_runs=cfg.max_runs,
        num_days=cfg.num_days, model=model, wave_loop="device")
    eps = tabc.calibrate_tolerance(ds, solo_cfg, seed=0, quantile=cfg.auto_quantile,
                                   n_pilot=cfg.pilot_size, device="cpu")
    assert eps == r.tolerance
    solo = tabc.run_abc(ds, dataclasses.replace(solo_cfg, tolerance=eps), seed=0,
                        device="cpu")
    theta, dist = _cell_rows(cfg, r)
    assert (solo.runs, solo.simulations, len(solo)) == (r.runs, r.simulations, r.n_accepted)
    np.testing.assert_array_equal(_bits(theta), _bits(solo.theta))
    np.testing.assert_array_equal(_bits(dist), _bits(solo.distances))
    assert list(r.posterior_mean) == list(solo.param_names)


def test_interrupted_scenario_resumes_bitwise(tmp_path):
    """A scenario dropped after one checkpointed segment resumes from
    run_idx 1 (no pilot, wave 0 not run again) to the uninterrupted set."""
    cfg = _cfg(tmp_path, datasets=("italy",), models=("siard",), target_accepted=50,
               checkpoint_every=1)
    whole = run_campaign(dataclasses.replace(cfg, out_dir=str(tmp_path / "whole")),
                         device="cpu").scenarios[0]
    assert whole.status == "ok" and whole.runs >= 2

    run = tcampaign._ScenarioRun(cfg.scenarios()[0], cfg, tcampaign._ShapeCache(cfg),
                                 torch.device("cpu"))
    run.launch()
    run.complete_segment()
    run.ckpt.wait()
    assert not run.done and run.ckpt.steps() == [1]
    del run

    calls = ref.CALLS
    r = run_campaign(cfg, device="cpu").scenarios[0]
    assert r.status == "ok"
    assert ref.CALLS - calls == r.runs - 1  # waves 1 .. runs-1 only
    assert (r.runs, r.simulations, r.n_accepted, r.tolerance) == (
        whole.runs, whole.simulations, whole.n_accepted, whole.tolerance)
    for a, b in zip(_cell_rows(cfg, r), _cell_rows(cfg, whole)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_campaign_skips_incompatible_cells(tmp_path):
    """sir observes (I, R); the country series are (A, R, D)."""
    cfg = _cfg(tmp_path, datasets=("italy",), models=("sir", "siard"), max_runs=20)
    by_model = {r.model: r for r in run_campaign(cfg, device="cpu").scenarios}
    assert by_model["sir"].status == "skipped"
    assert "observes" in by_model["sir"].detail
    assert by_model["siard"].status == "ok"


def test_only_incompatible_datasets_are_skipped(tmp_path):
    with pytest.raises(ValueError, match="observes"):
        run_campaign(_cfg(tmp_path, datasets=("italy",), models=("sir",),
                          skip_incompatible=False), device="cpu")
    with pytest.raises(KeyError, match="unknown dataset"):
        run_campaign(_cfg(tmp_path, datasets=("atlantis",), models=("siard",)),
                     device="cpu")


def test_scenario_grid_expansion():
    cfg = CampaignConfig(datasets=("a", "b"), models=("m",), seeds=(0, 1))
    grid = cfg.scenarios()
    assert len(grid) == 2 * 1 * 2
    assert grid[0] == Scenario(dataset="a", model="m", backend="cuda", seed=0)
    names = [s.name for s in grid]
    assert len(set(names)) == len(names)
    assert names[0] == "a__m__cuda__s0"


#: (schedule (tv, day, scale) or None, summary, distance) of each named cell
NAME_CELLS = [
    (None, None, "euclidean"),
    ((("alpha",), (5,), (0.4,)), None, "euclidean"),
    (None, "weekly", "euclidean"),
    (None, None, "normalized_euclidean"),
    ((("alpha",), (5, 9), (0.4, 0.8)), "weekly", "normalized_euclidean"),
    (None, dict(name="custom", cumulative=True, bin_days=7, log1p=True,
                channel_weights=(1.0, 0.5, 2.0)), "mae"),
    (None, dict(name="weekly", bin_days=7, region_pool=True), "euclidean"),
]


@pytest.mark.parametrize("cell", range(len(NAME_CELLS)))
def test_scenario_names_equal_repros(cell):
    """Names are `repro`'s letter for letter, with `cuda` as the backend;
    an inferred window's tag too."""
    sched, summary, distance = NAME_CELLS[cell]

    def parts(schedule_cls, summary_cls):
        return dict(schedule=None if sched is None else schedule_cls.fixed(*sched),
                    summary=summary_cls(**summary) if isinstance(summary, dict) else summary,
                    distance=distance)

    for seed in (0, 3):
        port = Scenario("italy", "siard", seed=seed, **parts(InterventionSchedule, SummarySpec))
        jax_sc = jcampaign.Scenario("italy", "siard", backend="cuda", seed=seed,
                                    **parts(JaxSchedule, JaxSummarySpec))
        assert port.name == jax_sc.name
    inferred = Scenario("italy", "siard", schedule=InterventionSchedule.inferred(
        ("alpha",), (20,), 0.1, 1.0)).name
    assert inferred == jcampaign.Scenario("italy", "siard", backend="cuda", schedule=(
        JaxSchedule.inferred(("alpha",), (20,), 0.1, 1.0))).name
    spec = regionalize(get_model("metapop_seir"), 100, "ring:0.1")
    assert Scenario("synthetic_small", spec).model_tag == spec.name


def test_report_keys_equal_repros(tmp_path):
    """The report's keys are those `repro`'s own campaign writes on one
    tiny cell; its config's are repro's less the JAX knobs, plus block."""
    kw = dict(datasets=("synthetic_small",), models=("siard",), batch_size=256,
              num_days=5, target_accepted=2, auto_quantile=0.05, pilot_size=256,
              max_runs=2, checkpoint_every=0)
    jcampaign.run_campaign(jcampaign.CampaignConfig(
        backends=("xla_fused",), out_dir=str(tmp_path / "jax"), **kw))
    run_campaign(CampaignConfig(out_dir=str(tmp_path / "port"), **kw), device="cpu")
    jax_rep, port_rep = (json.loads((tmp_path / d / "campaign_report.json").read_text())
                         for d in ("jax", "port"))
    assert set(port_rep) == set(jax_rep)
    assert set(port_rep["scenarios"][0]) == set(jax_rep["scenarios"][0])
    assert set(port_rep["config"]) == (set(jax_rep["config"]) - JAX_ONLY) | PORT_ONLY
    assert ({f.name for f in dataclasses.fields(CampaignConfig)}
            == ({f.name for f in dataclasses.fields(jcampaign.CampaignConfig)} - JAX_ONLY)
            | PORT_ONLY)
    # the same defaults where the fields are shared
    for f in dataclasses.fields(CampaignConfig):
        if f.name not in PORT_ONLY | {"datasets", "backends"}:
            assert f.default == jcampaign.CampaignConfig.__dataclass_fields__[f.name].default


def test_campaign_intervention_sweep_one_shape(tmp_path):
    """lockdown-day x scale grid: 4 scenarios, one shape (tests/test_interventions.py)."""
    ivs = tuple(InterventionSchedule.fixed(("alpha",), (day,), (scale,))
                for day in (5, 8) for scale in (0.4, 0.8))
    cfg = CampaignConfig(
        datasets=("synthetic_small",), models=("siard",), seeds=(0,), interventions=ivs,
        batch_size=1024, num_days=12, target_accepted=5, auto_quantile=0.02,
        pilot_size=1024, max_runs=30, out_dir=str(tmp_path / "iv_campaign"),
        checkpoint_every=8)
    report = run_campaign(cfg, device="cpu")
    assert len(report.scenarios) == 4
    assert report.compiled_shapes == 1
    names = set()
    for r in report.scenarios:
        assert r.status == "ok", (r.name, r.status, r.detail)
        names.add(r.name)
        # the pinned scale comes back exactly (zero-width prior dim)
        sc = [s for s in ivs if s.tag() in r.name][0]
        assert r.posterior_mean["alpha_w1"] == pytest.approx(sc.fixed_scales()[0][0],
                                                             rel=1e-5)
    assert len(names) == 4
    payload = json.loads((tmp_path / "iv_campaign" / "campaign_report.json").read_text())
    assert len(payload["scenarios"]) == 4


def test_campaign_summary_axis(tmp_path):
    """tests/test_summaries.py: a summary cell per shape entry."""
    cfg = CampaignConfig(
        datasets=("synthetic_small",), models=("siard",), summaries=(None, "weekly"),
        distance="normalized_euclidean", batch_size=1024, num_days=15,
        target_accepted=10, max_runs=10, auto_quantile=0.02, pilot_size=1024,
        out_dir=str(tmp_path), checkpoint_every=0)
    report = run_campaign(cfg, device="cpu")
    assert len(report.scenarios) == 2
    names = {r.name for r in report.scenarios}
    assert len(names) == 2
    assert any("bin7" in n or "weekly" in n for n in names)
    for r in report.scenarios:
        assert r.status in ("ok", "budget_exhausted")
        assert r.n_accepted > 0
    assert report.compiled_shapes == 2


def test_campaign_100_region_smoke(tmp_path):
    """tests/test_metapop.py: two seeds of a 100-region spec object share
    one shape entry and one simulator."""
    spec = regionalize(get_model("metapop_seir"), 100, "ring:0.1")
    cfg = CampaignConfig(
        datasets=("synthetic_small",), models=(spec,), seeds=(0, 1), batch_size=256,
        num_days=8, target_accepted=4, auto_quantile=0.05, pilot_size=256,
        max_runs=12, out_dir=str(tmp_path / "camp100"), checkpoint_every=8)
    report = run_campaign(cfg, device="cpu")
    assert len(report.scenarios) == 2
    for r in report.scenarios:
        assert r.status == "ok", (r.name, r.status, r.detail)
        assert r.model == spec.name  # serialized by tag, not by object
        assert r.n_accepted >= cfg.target_accepted
    assert report.compiled_shapes == 1
    assert report.config["models"] == (spec.name,)


def test_shape_cache_shares_simulators_and_mobility(monkeypatch):
    """A hit makes a simulator only for a new (dataset, schedule); a
    regional entry passes the first simulator's mobility buffer on."""
    made = []

    class Sim:
        def __init__(self, mob):
            self.mob = "mob0" if mob is None else mob

    def fake(dataset, cfg, device, mob=None):
        made.append((dataset.name, cfg.schedule, mob))
        return Sim(mob)

    monkeypatch.setattr(tcampaign, "make_simulator", fake)
    spec = regionalize(get_model("metapop_seir"), 3, "ring:0.1")
    cfg = CampaignConfig(datasets=("synthetic_small",), models=(spec,), num_days=8)
    cache = tcampaign._ShapeCache(cfg)
    ds = get_dataset("synthetic_small", num_days=8, model=spec)
    cpu = torch.device("cpu")
    early, late = (InterventionSchedule.fixed(("beta",), (d,), (0.5,)) for d in (3, 5))
    a = cache.simulator(Scenario("synthetic_small", spec, schedule=early), ds, cpu)
    b = cache.simulator(Scenario("synthetic_small", spec, seed=1, schedule=early), ds, cpu)
    c = cache.simulator(Scenario("synthetic_small", spec, schedule=late), ds, cpu)
    assert a is b and c is not a and cache.n_compiled == 1
    assert made == [("synthetic_small", early, None), ("synthetic_small", late, "mob0")]


def test_cli_campaign_writes_report_and_resumes(tmp_path):
    argv = ["--campaign", "--device", "cpu", "--datasets", "italy", "new_zealand",
            "--models", "siard", "--days", "10", "--batch", "1024", "--auto-tolerance",
            "0.02", "--accept", "6", "--max-runs", "40", "--out", str(tmp_path)]
    report = abc_run.main(argv)
    assert [r.status for r in report.scenarios] == ["ok", "ok"]
    assert report.config["auto_quantile"] == 0.02 and report.config["tolerance"] is None
    assert (tmp_path / "campaign_report.json").is_file()
    again = abc_run.main(argv)
    assert [r.status for r in again.scenarios] == ["resumed_complete"] * 2


@pytest.mark.parametrize("flag,value", [("--dataset", "italy"), ("--model", "seiard"),
                                        ("--seed", "1"), ("--intervention", "alpha@5=0.4"),
                                        ("--summary", "weekly")])
def test_cli_refuses_singular_flags_with_campaign(flag, value, capsys):
    with pytest.raises(SystemExit):
        abc_run.main(["--campaign", "--device", "cpu", flag, value])
    assert "no effect with --campaign" in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [("--datasets", "italy"), ("--models", "seiard"),
                                        ("--seeds", "1"), ("--interventions", "alpha@5=0.4"),
                                        ("--summaries", "weekly")])
def test_cli_refuses_grid_flags_without_campaign(flag, value, capsys):
    with pytest.raises(SystemExit):
        abc_run.main(["--device", "cpu", flag, value])
    assert "no effect without --campaign" in capsys.readouterr().err


def test_other_backends_are_refused(capsys):
    with pytest.raises(SystemExit):
        abc_run.main(["--campaign", "--device", "cpu", "--backends", "xla_fused"])
    assert "invalid choice" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown backends"):
        CampaignConfig(datasets=("italy",), backends=("cuda", "pallas"))


def test_devices_per_scenario_above_one_raises(tmp_path):
    """More devices a scenario than the campaign is given is refused, as
    `repro` refuses more than its visible devices (the CPU is one device)."""
    cfg = CampaignConfig(datasets=("italy",), devices_per_scenario=2, out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        run_campaign(cfg, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        CampaignConfig(datasets=("italy",), devices_per_scenario=0)
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        abc_run.main(["--campaign", "--device", "cpu", "--devices-per-scenario", "2",
                      "--out", str(tmp_path)])


def test_campaign_disjoint_device_groups(tmp_path):
    """devices_per_scenario=2 on four devices ([cpu] * 4, the port's analogue
    of `repro`'s forced host device count; tests/test_scaling.py:226): two
    scenarios on the disjoint groups "0+1" and "2+3", each bitwise its solo
    2-shard reference run (calibrate_tolerance + run_abc on
    `make_reference_wave_runner`), checkpointed with `repro`'s per-shard
    fills, and resumed complete with no launch."""
    from repro_torch.core.scaling import make_reference_wave_runner

    cfg = CampaignConfig(
        datasets=("italy", "usa"), models=("siard",), batch_size=1024, num_days=12,
        target_accepted=20, max_runs=300, auto_quantile=2e-3, pilot_size=1024,
        out_dir=str(tmp_path), checkpoint_every=4, devices_per_scenario=2)
    rep = run_campaign(cfg, device=["cpu"] * 4)
    assert [r.status for r in rep.scenarios] == ["ok", "ok"]
    assert [r.device for r in rep.scenarios] == ["0+1", "2+3"]
    assert all(r.n_accepted >= 20 for r in rep.scenarios)
    capacity = tabc.wave_capacity(cfg.abc_config(cfg.scenarios()[0], 1.0), 512)
    for r in rep.scenarios:
        ds = get_dataset(r.dataset, num_days=12)
        shape = cfg.abc_config(cfg.scenarios()[0], 1.0)
        eps = tabc.calibrate_tolerance(ds, shape, seed=0, quantile=cfg.auto_quantile,
                                       n_pilot=cfg.pilot_size, device="cpu")
        solo_cfg = dataclasses.replace(shape, tolerance=eps)
        prior = get_model("siard").prior()
        runner = make_reference_wave_runner(prior, tabc.make_simulator(ds, solo_cfg, "cpu"),
                                            solo_cfg, 2)
        solo = tabc.run_abc(ds, solo_cfg, seed=0, wave_runner=runner)
        assert (eps, solo.runs, solo.simulations) == (r.tolerance, r.runs, r.simulations)
        like = {"theta_buf": np.zeros((2 * capacity, 8), np.float32),
                "dist_buf": np.zeros((2 * capacity,), np.float32)}
        tree, meta, _ = load_checkpoint(r.checkpoint_dir, like)
        fills = meta["fills"]
        assert len(fills) == 2 and meta["fill"] == sum(fills) == len(solo)
        theta = np.concatenate([tree["theta_buf"][s * capacity:s * capacity + c]
                                for s, c in enumerate(fills)])
        np.testing.assert_array_equal(_bits(theta), _bits(solo.theta))
    calls = ref.CALLS
    rep2 = run_campaign(cfg, device=["cpu"] * 4)
    assert [r.status for r in rep2.scenarios] == ["resumed_complete"] * 2
    assert ref.CALLS == calls


def test_checkpoint_of_another_layout_restarts_with_a_message(tmp_path, capsys):
    cfg = _cfg(tmp_path, datasets=("italy",), models=("siard",))
    run_campaign(cfg, device="cpu")
    # a wider batch: the same scenario name, a larger accept buffer
    r = run_campaign(dataclasses.replace(cfg, batch_size=2048, pilot_size=2048),
                     device="cpu").scenarios[0]
    assert r.status == "ok" and r.simulations == r.runs * 2048
    assert "checkpoint layout does not match" in capsys.readouterr().out


@pytest.mark.parametrize("damage", ["manifest", "leaf"])
def test_other_restore_errors_raise(tmp_path, damage):
    cfg = _cfg(tmp_path, datasets=("italy",), models=("siard",))
    r = run_campaign(cfg, device="cpu").scenarios[0]
    step = sorted(Path(r.checkpoint_dir).glob("step_*"))[-1]
    if damage == "manifest":
        (step / "manifest.json").write_text("{not json")
        with pytest.raises(ValueError):
            run_campaign(cfg, device="cpu")
    else:
        manifest = json.loads((step / "manifest.json").read_text())
        manifest["leaves"] = manifest["leaves"][:1]
        (step / "manifest.json").write_text(json.dumps(manifest))
        with pytest.raises(KeyError, match="theta_buf"):
            run_campaign(cfg, device="cpu")


# ---------------------------------------------------------------- checkpoints

def _tree(seed=0):
    g = np.random.default_rng(seed)
    return {"w": torch.from_numpy(g.standard_normal((4, 8)).astype(np.float32)),
            "b": np.zeros(8, np.float32),
            "step": np.asarray(7, np.int32),
            "ids": torch.arange(5, dtype=torch.int64)}


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 3, t, metadata={"note": "x"})
    restored, meta, step = load_checkpoint(tmp_path, t)
    assert step == 3 and meta["note"] == "x"
    _assert_tree_equal(restored, t)
    manifest = json.loads((tmp_path / "step_0000000003" / "manifest.json").read_text())
    assert [e["path"] for e in manifest["leaves"]] == ["['b']", "['ids']", "['step']", "['w']"]
    assert set(manifest) == {"step", "time", "metadata", "leaves"}


def test_checkpoint_latest_selected_and_keep_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.steps() == [3, 4]
    restored, _, step = ck.restore(_tree())
    assert step == 4
    _assert_tree_equal(restored, _tree(4))
    _, _, step = ck.restore(_tree(), step=3)
    assert step == 3


def test_checkpoint_async_save_commits(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    t = _tree(1)
    ck.save_async(5, t, metadata={"rng": 123})
    ck.wait()
    restored, meta, step = ck.restore(_tree())
    assert step == 5 and meta["rng"] == 123
    _assert_tree_equal(restored, t)


def test_checkpoint_async_error_comes_back_at_wait(tmp_path):
    (tmp_path / "file").write_text("")
    ck = Checkpointer(tmp_path / "file" / "sub")
    ck.save_async(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once


def test_checkpoint_crash_mid_write_never_corrupts(tmp_path):
    """A leftover .tmp directory (a crash mid-write) is never read."""
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    bad = tmp_path / "step_0000000002.tmp"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"garbage")
    _, _, step = load_checkpoint(tmp_path, t)
    assert step == 1
    assert Checkpointer(tmp_path).steps() == [1]


def test_checkpoint_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(tmp_path, {"w": torch.zeros((2, 2))})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(tmp_path, {"v": torch.zeros((4, 4))})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "none", {"w": torch.zeros((4, 4))})
    with pytest.raises(TypeError, match="flat dict"):
        save_checkpoint(tmp_path, 2, {"a": {"b": np.zeros(2)}})


def _campaign_tree(seed=0):
    g = np.random.default_rng(seed)
    return {"theta_buf": g.standard_normal((33, 8)).astype(np.float32),
            "dist_buf": g.standard_normal(33).astype(np.float32)}


META = {"run_idx": 3, "fill": 5, "eps_schedule": [1.5], "done": False,
        "scenario": {"dataset": "italy", "model": "siard"}}


def test_checkpoint_from_repro_loads_in_the_port(tmp_path):
    t = _campaign_tree(1)
    jckpt.save_checkpoint(tmp_path, 7, t, metadata=META)
    restored, meta, step = load_checkpoint(tmp_path, t)
    assert step == 7 and meta == META
    _assert_tree_equal(restored, t)


def test_checkpoint_from_the_port_loads_in_repro(tmp_path):
    t = _campaign_tree(2)
    Checkpointer(tmp_path).save(7, {k: torch.from_numpy(v) for k, v in t.items()}, META)
    restored, meta, step = jckpt.load_checkpoint(tmp_path, t)
    assert step == 7 and meta == META
    _assert_tree_equal({k: np.asarray(v) for k, v in restored.items()}, t)


# ---------------------------------------------------------- checkpoint cadence
#: cells that run past 32 waves (ROADMAP.md's reproduction of the cadence
#: fault: batch 256, 10 days, target 120, quantile 0.005, pilot 1024)
CADENCE = dict(datasets=("italy", "synthetic_small"), models=("siard",), batch_size=256,
               num_days=10, target_accepted=120, auto_quantile=0.005, pilot_size=1024,
               max_runs=100)


@pytest.fixture(scope="module")
def cadence(tmp_path_factory):
    """The cadence campaign under checkpoint_every 0, 16 and 32, with the
    step of every checkpoint each cell wrote."""
    out = {}
    for every in (0, 16, 32):
        saved = {}
        real = Checkpointer.save_async

        def spy(self, step, tree, metadata=None):
            saved.setdefault(self.directory.name, []).append(step)
            return real(self, step, tree, metadata)

        Checkpointer.save_async = spy
        try:
            cfg = CampaignConfig(out_dir=str(tmp_path_factory.mktemp(f"every{every}")),
                                 checkpoint_every=every, **CADENCE)
            report = run_campaign(cfg, device="cpu")
        finally:
            Checkpointer.save_async = real
        out[every] = (cfg, report, saved)
    return out


@pytest.mark.parametrize("every", [0, 16, 32])
def test_campaign_checkpoints_at_repros_cadence(cadence, every):
    """repro's contract (src/repro/core/campaign.py:148-150): a checkpoint at
    each multiple of checkpoint_every and at the finishing run; with 0 only
    at the finishing run."""
    _, report, saved = cadence[every]
    for r in report.scenarios:
        assert r.status == "ok" and r.runs > 32, (r.name, r.status, r.runs)
        want = [s for s in range(every, r.runs, every)] if every else []
        assert saved[r.name] == want + [r.runs], (r.name, saved[r.name])


@pytest.mark.parametrize("every", [0, 16, 32])
@pytest.mark.parametrize("dataset", CADENCE["datasets"])
def test_cadence_cells_equal_their_solo_runs(cadence, every, dataset):
    """Whatever the cadence, a cell is bitwise its solo run."""
    cfg, report, _ = cadence[every]
    r = next(s for s in report.scenarios if s.dataset == dataset)
    ds = get_dataset(dataset, num_days=cfg.num_days)
    solo_cfg = tabc.ABCConfig(
        batch_size=cfg.batch_size, tolerance=1.0, target_accepted=cfg.target_accepted,
        strategy="outfeed", chunk_size=cfg.batch_size, max_runs=cfg.max_runs,
        num_days=cfg.num_days, wave_loop="device")
    eps = tabc.calibrate_tolerance(ds, solo_cfg, seed=0, quantile=cfg.auto_quantile,
                                   n_pilot=cfg.pilot_size, device="cpu")
    solo = tabc.run_abc(ds, dataclasses.replace(solo_cfg, tolerance=eps), seed=0,
                        device="cpu")
    assert (eps, solo.runs, solo.simulations, len(solo)) == (
        r.tolerance, r.runs, r.simulations, r.n_accepted)
    theta, dist = _cell_rows(cfg, r)
    np.testing.assert_array_equal(_bits(theta), _bits(solo.theta))
    np.testing.assert_array_equal(_bits(dist), _bits(solo.distances))
