"""The port's cost model, tuning cache and autotuner (`repro_torch.core.tuning`)
against `repro.core.tuning`, case by case as tests/test_tuning.py.

  * the cost model is derived from the spec: its byte fields and theta
    width equal `repro`'s, and its operation count a sample-day lies within
    rtol 0.15 of `repro`'s and of the port's own count over a full
    `ref.abc_sim_distance_ref` run (`repro`'s bar, tests/test_tuning.py);
  * the cache round-trips, a hit measures nothing, corrupt caches raise;
  * the block is pure scheduling: an autotuned run's posterior is bitwise
    the untuned one's (the card's bitwise check across blocks is
    tests/test_torch_gpu.py's and chip_smoke.py's).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import tuning as jtuning
from repro.epi.spec import InterventionSchedule as JSchedule
from repro_torch.core import tuning
from repro_torch.core.abc import ABCConfig, run_abc
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule
from repro_torch.kernels import abc_sim, ref
from repro_torch.kernels import rng as krng
from repro_torch.launch import abc_run

torch.set_num_threads(1)

DAYS = 10
#: `repro`'s bar for the operation count (tests/test_tuning.py:63-64)
FLOPS_RTOL = 0.15
#: the one-window schedule of the scheduled-siard case, in both packages
SCHED = dict(tv_params=("alpha0",), breakpoints=(25,), scale_lows=((0.0,),),
             scale_highs=((2.0,),))
COST_CASES = ("siard", "sir", "seir", "seiard", "siard+schedule", "metapop_seir")


@pytest.fixture(scope="module")
def ds():
    return get_dataset("synthetic_small", num_days=DAYS)


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    """The default cache under tmp_path: nothing writes into the checkout."""
    path = tmp_path / "cache_torch.json"
    monkeypatch.setattr(tuning, "DEFAULT_CACHE_PATH", path)
    return path


def _cost_pair(case):
    name, _, sched = case.partition("+")
    port = tuning.cost_model(name, 49, schedule=InterventionSchedule(**SCHED) if sched else None)
    theirs = jtuning.cost_model(name, 49, schedule=JSchedule(**SCHED) if sched else None)
    return port, theirs


# --------------------------------------------------------------------------
# Cost model: spec-derived, against repro's and against the full plain run
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", COST_CASES)
def test_cost_model_matches_repro(case):
    """Byte fields and theta width equal; the operation count within
    rtol 0.15 of repro's jaxpr count."""
    port, theirs = _cost_pair(case)
    for field in ("theta_width", "fused_bytes_per_sample", "naive_bytes_per_sample_day",
                  "n_transitions", "n_state", "n_observed", "n_regions", "days"):
        assert getattr(port, field) == getattr(theirs, field), field
    ratio = port.flops_per_sample_day / theirs.flops_per_sample_day
    assert abs(ratio - 1) <= FLOPS_RTOL, (
        f"{case}: port {port.flops_per_sample_day:.2f} vs repro "
        f"{theirs.flops_per_sample_day:.2f} ops a sample-day, ratio {ratio:.4f} "
        f"(rtol {FLOPS_RTOL})")


@pytest.mark.parametrize("model", ["sir", "seir", "siard", "seiard", "metapop_seir"])
def test_cost_model_flops_cross_check_vs_ref(model):
    """The one-day count behind `cost_model` against the same counter over
    the FULL plain run (initial state, finalize and the observed side
    amortized over batch x days)."""
    spec = get_model(model)
    days, batch = 30, 256
    cm = tuning.cost_model(model, days)
    obs = torch.ones((spec.total_observed, days))
    theta = torch.ones((batch, spec.n_params))

    def full(th):
        return ref.abc_sim_distance_ref(th, 0, obs, population=1e6, a0=100.0, r0=5.0,
                                        d0=1.0, model=spec)

    per_sample_day = tuning.count_fn_ops(full, theta) / (batch * days)
    ratio = per_sample_day / cm.flops_per_sample_day
    assert abs(ratio - 1) <= FLOPS_RTOL, (
        f"{model}: full run {per_sample_day:.2f} vs one day {cm.flops_per_sample_day:.2f}, "
        f"ratio {ratio:.4f} (rtol {FLOPS_RTOL})")
    assert cm.flops_per_sample_day > 50  # a real count, not 0


def test_count_fn_ops_counts_emulated_words_as_uint32_operations():
    """A `_mul32` is one multiply an element and a `& MASK32` is free; a
    float add counts one an element; views and factories count nothing."""
    x = torch.arange(64, dtype=torch.int64)
    assert tuning.count_fn_ops(lambda v: krng._mul32(v, krng.M1), x) == 64
    assert tuning.count_fn_ops(lambda v: v & krng.MASK32, x) == 0
    assert tuning.count_fn_ops(lambda v: v & 0xFFFF, x) == 64
    assert tuning.count_fn_ops(lambda v: krng.fmix32(v), x) == 8 * 64
    y = torch.ones((4, 8))
    assert tuning.count_fn_ops(lambda v: v.reshape(32)[:5] + torch.zeros(5), y) == 5
    # the hash of one sample and counter: fmix32 twice (16), the index
    # product (1) and three xors (3); the counter's product is arithmetic on
    # Python ints, which no tensor sees
    idx = torch.arange(16, dtype=torch.int64)
    assert tuning.count_fn_ops(lambda i: krng.hash_u32(7, i, 3), idx) == 20 * 16


def test_cost_model_bytes_reproduce_seed_constants():
    """SIARD: fused 8*4+4 = 36 B a sample, naive (5+3+2*6)*4 = 80 B a
    sample-day; smaller models shrink with the spec."""
    cm = tuning.cost_model("siard", 49)
    assert cm.fused_bytes_per_sample == 36.0
    assert cm.naive_bytes_per_sample_day == 80.0
    assert cm.theta_width == 8
    sir = tuning.cost_model("sir", 49)
    assert sir.fused_bytes_per_sample == (sir.theta_width + 1) * 4.0 < 36.0


def test_cost_model_schedule_widens_theta():
    sched = InterventionSchedule(tv_params=("beta",), breakpoints=(10,),
                                 scale_lows=((0.1,),), scale_highs=((1.0,),))
    base = tuning.cost_model("siard", 49)
    wide = tuning.cost_model("siard", 49, schedule=sched)
    assert wide.theta_width > base.theta_width
    assert wide.fused_bytes_per_sample > base.fused_bytes_per_sample
    assert wide.flops_per_sample_day > base.flops_per_sample_day  # the window select


def test_roofline_fields_shape_and_ceiling():
    cm = tuning.cost_model("siard", 49)
    out = tuning.roofline_metrics(cm, n_samples=1e6, wall_s=1.0)
    assert set(out) == {"achieved_flops", "achieved_bytes_per_s", "arithmetic_intensity",
                        "roofline_efficiency"}
    assert out["achieved_flops"] == pytest.approx(cm.flops(1e6))
    # the simulation is operation-bound: the ceiling is the float32 rate
    assert out["arithmetic_intensity"] * tuning.HBM_BYTES_PER_S > tuning.F32_OPS_PER_S
    assert out["roofline_efficiency"] == pytest.approx(cm.flops(1e6) / tuning.F32_OPS_PER_S)
    assert 0 < out["roofline_efficiency"] < 1
    slow = tuning.roofline_metrics(cm, n_samples=1e6, wall_s=2.0)
    assert slow["roofline_efficiency"] == pytest.approx(out["roofline_efficiency"] / 2)
    assert slow["achieved_flops"] == pytest.approx(out["achieved_flops"] / 2)


# --------------------------------------------------------------------------
# Tuning cache: round-trip, hit-skips-measurement, loud corruption
# --------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(batch_size=512, chunk_size=512, num_days=DAYS, tolerance=1.6e4,
                target_accepted=5, max_runs=2)
    base.update(kw)
    return ABCConfig(**base)


def test_cache_round_trip(tmp_path):
    path = tmp_path / "cache.json"
    cache = tuning.TuningCache(path)
    assert cache.get("k") is None
    cache.put("k", {"block": 128})
    assert cache.get("k") == {"block": 128}
    assert tuning.TuningCache(path).get("k") == {"block": 128}
    payload = json.loads(path.read_text())
    assert payload["schema"] == tuning.CACHE_SCHEMA == jtuning.CACHE_SCHEMA
    assert list(tmp_path.iterdir()) == [path]  # no temp file left behind


def test_default_cache_is_the_ports_own():
    assert tuning.DEFAULT_CACHE_PATH.name == "cache_torch.json"
    assert tuning.DEFAULT_CACHE_PATH.parent == jtuning.DEFAULT_CACHE_PATH.parent


def test_corrupt_cache_raises_loudly(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    with pytest.raises(ValueError, match="corrupt tuning cache.*repro_torch.core.tuning"):
        tuning.TuningCache(path).get("k")
    path.write_text(json.dumps({"schema": "something-else", "entries": {}}))
    with pytest.raises(ValueError, match="not a tuning-cache/v1"):
        tuning.TuningCache(path).get("k")
    path.write_text(json.dumps({"schema": tuning.CACHE_SCHEMA}))
    with pytest.raises(ValueError, match="not a tuning-cache/v1"):
        tuning.TuningCache(path).get("k")


def test_autotune_hit_skips_measurement(tmp_path, ds):
    cache = tuning.TuningCache(tmp_path / "cache.json")
    cfg = _cfg(autotune=True)
    calls = []

    def fake_measure(c, batch=None):
        calls.append((c.block, batch))
        return 0.5 if c.block == 128 else 1.0  # block 128 "wins"

    entry = tuning.autotune(ds, cfg, cache=cache, measure=fake_measure,
                            measure_batches=False, device="cpu")
    assert calls, "a cache miss must measure"
    assert entry["block"] == 128 and entry["device"] == "cpu"
    calls.clear()
    assert tuning.autotune(ds, cfg, cache=cache, measure=fake_measure) == entry
    assert calls == []
    fresh = tuning.TuningCache(tmp_path / "cache.json")
    assert tuning.autotune(ds, cfg, cache=fresh, measure=fake_measure)["block"] == 128
    assert calls == []


def test_autotune_searches_block_and_records_best_batch(tmp_path, ds):
    cache = tuning.TuningCache(tmp_path / "cache.json")
    cfg = _cfg(autotune=True)
    seen = []

    def fake_measure(c, batch=None):
        seen.append((c.block, batch))
        if batch is not None:
            return batch / (1e6 if batch == 1024 else 5e5)  # 1024 a wave is fastest
        return 0.25 if c.block == 64 else 1.0

    entry = tuning.autotune(ds, cfg, cache=cache, measure=fake_measure, device="cpu")
    assert [b for b, n in seen if n is None] == list(tuning.block_candidates("siard", 512))
    assert entry["block"] == 64
    assert entry["best_batch"] == 1024  # advisory only
    assert set(entry["measurements"]) == {"block64", "block128", "block256", "batch256",
                                          "batch512", "batch1024"}
    assert entry["schedule"] == "nosched" and entry["model"] == "siard"


def test_autotune_refuses_npe(ds):
    with pytest.raises(ValueError, match="autotune tunes the cuda backend"):
        ABCConfig(backend="npe", autotune=True)
    with pytest.raises(ValueError, match="autotune tunes the cuda backend"):
        tuning.autotune(ds, _cfg(backend="npe"))


def test_resolve_tuned_applies_winner_but_explicit_wins(tmp_path, ds):
    cache = tuning.TuningCache(tmp_path / "cache.json")
    cfg = _cfg(autotune=True)
    cache.put(tuning.cfg_cache_key(cfg), {"block": 64, "best_batch": 1024})
    tuned = tuning.resolve_tuned(ds, cfg, cache=cache)
    assert tuned.block == 64
    assert tuned.autotune is False
    assert tuned.batch_size == cfg.batch_size  # best_batch is advisory only
    explicit = dataclasses.replace(cfg, block=128)
    assert tuning.resolve_tuned(ds, explicit, cache=cache).block == 128
    off = dataclasses.replace(cfg, autotune=False)
    assert tuning.resolve_tuned(ds, off, cache=cache) is off


@pytest.mark.parametrize("model,regions,batch,want", [
    ("siard", 1, 100_000, (64, 128, 256)),  # the flat kernel
    ("metapop_seir", 4, 100_000, (64, 128, 256)),  # the thread route only
    ("seir", 12, 20_000, (64, 128, 256)),  # both routes: the thread route's bound
    ("metapop_seir", 100, 20_000, (64, 128, 256, 384, 512)),  # the warp route only
])
def test_block_candidates_respect_launch_bounds(model, regions, batch, want):
    from repro_torch.epi.spec import regionalize

    spec = get_model(model)
    if regions != spec.n_regions:
        spec = regionalize(spec, regions, "ring:0.1")
    cands = tuning.block_candidates(spec, batch)
    assert cands == want
    for block in cands:
        abc_sim.check_kernel_block(spec, block)  # every one a config may name
    route = abc_sim.regional_route(spec, batch) if spec.is_regional else "thread"
    default = abc_sim.route_block(route)
    assert (default in cands) == (default <= max(want))


def test_cache_key_separates_the_tuning_dimensions():
    sched = InterventionSchedule.inferred(("alpha0",), (20,))
    keys = {
        tuning.cache_key(backend="cuda", model=m, days=d, batch=n, summary=su, distance=di,
                         schedule=sc)
        for m in ("siard", "seiard")
        for d in (10, 49)
        for n in (512, 8192)
        for su in ("identity", "log_weekly")
        for di in ("euclidean", "mae")
        for sc in (None, sched)
    }
    assert len(keys) == 64
    assert tuning.cache_key(backend="cuda", model="siard", days=49, batch=100_000) == \
        "cuda/siard/d49/b100000/identity/euclidean/nosched"
    assert tuning.cfg_cache_key(_cfg(schedule=sched)).endswith("/w1tv1")
    # the key of a spec is its name, as repro's
    assert tuning.cfg_cache_key(_cfg(model=get_model("sir"))) == \
        jtuning.cache_key(backend="cuda", model="sir", days=DAYS, batch=512)


# --------------------------------------------------------------------------
# The winner is pure scheduling: an autotuned run is the untuned one
# --------------------------------------------------------------------------

def test_run_abc_autotune_is_bitwise_the_untuned_run(ds, cache_path):
    cfg = _cfg(tolerance=3e3, target_accepted=20, max_runs=4, chunk_size=128)
    tuning.TuningCache(cache_path).put(tuning.cfg_cache_key(cfg), {"block": 64})
    plain = run_abc(ds, cfg, seed=3, device="cpu")
    tuned = run_abc(ds, dataclasses.replace(cfg, autotune=True), seed=3, device="cpu")
    assert plain.simulations > 0 and len(plain) > 0
    assert (tuned.runs, tuned.simulations) == (plain.runs, plain.simulations)
    assert np.array_equal(tuned.theta, plain.theta)
    assert np.array_equal(tuned.distances, plain.distances)


def test_autotune_miss_measures_the_plain_version_on_the_cpu(ds, cache_path):
    """A real miss on the CPU: every candidate and batch measured, the
    winner persisted in the default cache, the next call a hit."""
    cfg = _cfg(batch_size=256, chunk_size=256, num_days=6, autotune=True)
    entry = tuning.autotune(ds, cfg, reps=1, device="cpu")
    assert entry["block"] in tuning.block_candidates("siard", 256)
    assert entry["device"] == "cpu" and entry["best_batch"] in (256, 512)
    assert all(v > 0 for v in entry["measurements"].values())
    assert json.loads(cache_path.read_text())["entries"][tuning.cfg_cache_key(cfg)] == entry
    assert tuning.measure_simulator(ds, cfg, reps=1, warmup=0, device="cpu") > 0


SINGLE = ["--device", "cpu", "--dataset", "synthetic_small", "--days", "8", "--batch", "256",
          "--chunk", "64", "--tolerance", "3e3", "--accept", "8", "--max-runs", "3"]


def test_abc_run_autotune_single_run(cache_path):
    plain = abc_run.main(SINGLE)
    tuned = abc_run.main(SINGLE + ["--autotune"])
    entries = json.loads(cache_path.read_text())["entries"]
    assert list(entries) == ["cuda/siard/d8/b256/identity/euclidean/nosched"]
    assert np.array_equal(tuned.theta, plain.theta)
    assert np.array_equal(tuned.distances, plain.distances)
    with pytest.raises(SystemExit):
        abc_run.main(["--device", "cpu", "--backend", "npe", "--autotune"])


def test_abc_run_autotune_campaign(cache_path, tmp_path):
    argv = ["--campaign", "--device", "cpu", "--datasets", "italy", "usa", "--models",
            "siard", "--days", "8", "--batch", "256", "--tolerance", "1e4", "--accept",
            "5", "--max-runs", "3"]
    plain = abc_run.main(argv + ["--out", str(tmp_path / "plain")])
    # a planted winner: the shape's one entry, read once for both datasets
    key = "cuda/siard/d8/b256/identity/euclidean/nosched"
    tuning.TuningCache(cache_path).put(key, {"block": 128})
    tuned = abc_run.main(argv + ["--autotune", "--out", str(tmp_path / "tuned")])
    assert [r.status for r in tuned.scenarios] == [r.status for r in plain.scenarios]
    for a, b in zip(plain.scenarios, tuned.scenarios):
        assert (a.n_accepted, a.runs, a.simulations) == (b.n_accepted, b.runs, b.simulations)
        assert a.posterior_mean == b.posterior_mean
    assert tuned.compiled_shapes == 1
    assert tuned.config["autotune"] is True


def test_campaign_shape_cache_tunes_once_a_shape(cache_path, monkeypatch):
    from repro_torch.core import campaign

    resolved = []
    real = tuning.resolve_tuned

    def spy(dataset, cfg, cache=None, device="cuda"):
        resolved.append(dataset.name)
        return real(dataset, cfg, cache=cache, device=device)

    monkeypatch.setattr(tuning, "resolve_tuned", spy)
    tuning.TuningCache(cache_path).put("cuda/siard/d8/b256/identity/euclidean/nosched",
                                       {"block": 64})
    cfg = campaign.CampaignConfig(datasets=("italy", "usa"), batch_size=256, num_days=8,
                                  autotune=True)
    cache = campaign._ShapeCache(cfg)
    cpu = torch.device("cpu")
    sims = [cache.simulator(campaign.Scenario(d, "siard"), get_dataset(d, num_days=8), cpu)
            for d in ("italy", "usa")]
    assert resolved == ["italy"]  # the first dataset that reaches the shape
    assert [s.block for s in sims] == [64, 64]


def test_abc_run_autotune_scaling(cache_path, tmp_path):
    out = tmp_path / "scaling.json"
    report = abc_run.main(["--scaling", "--device", "cpu", "--models", "sir", "--batch",
                           "256", "--days", "6", "--scaling-devices", "1",
                           "--scaling-waves", "2", "--scaling-reps", "1", "--autotune",
                           "--scaling-out", str(out)])
    assert report["config"]["autotune"] is True
    cell = report["cells"]["sir/cuda/b256/n1"]
    assert cell["waves"] == 2 and cell["simulations"] == 512
    entries = json.loads(cache_path.read_text())["entries"]
    assert "cuda/sir/d6/b256/identity/euclidean/nosched" in entries  # a real miss, measured
