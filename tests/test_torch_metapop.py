"""The port's region axis (metapop_seir, regionalize, mobility,
region-pooled summaries) against `repro`'s.

Mirrors tests/test_metapop.py: the mobility grammar and its loud errors,
the counter stride, the plain version of the fused kernel at R=4 against
`repro`'s pure-jnp oracle, identity mobility as independent regions, ring
coupling, the mobility override, `region_pooled` at R=1, the ABC recovery
bar on a 4-region series and the 100-region CLI run. Inputs (theta, the
observed series, the mobility matrices) come from `repro` at test time and
cross as numpy arrays or nested tuples.

The oracle is jitted with (population, a0, r0, d0) as run-time values, as
the kernels read them (see tests/test_torch_abc_sim.py). Its bar is
`repro`'s own kernel-against-oracle bar for metapop, rtol=2e-5, atol=1e-2
(tests/test_metapop.py:250): the oracle sums a coupled row by einsum
(src/repro/epi/engine.py:203-206), the TPU kernel body and the port left to
right from the first product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summaries as jsum
from repro.epi import engine as jengine
from repro.epi import spec as jspec
from repro.epi.data import get_dataset as jax_get_dataset
from repro.epi.data import synthetic_dataset as jax_synthetic_dataset
from repro.epi.models import get_model as jax_get_model
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import abc as tabc
from repro_torch.core import summaries as tsum
from repro_torch.epi import data as tdata
from repro_torch.epi import engine as tengine
from repro_torch.epi.models import get_model, list_models
from repro_torch.epi.spec import (
    EpiModelConfig,
    identity_mobility,
    make_mobility,
    regionalize,
    validate_mobility,
)
from repro_torch.kernels import abc_sim, ops, sass
from repro_torch.kernels import rng as krng
from repro_torch.launch import abc_run

torch.set_num_threads(1)

BAR = dict(rtol=2e-5, atol=1e-2)
FLAT = ("siard", "sir", "seir", "seiard")
MP = get_model("metapop_seir")
JMP = jax_get_model("metapop_seir")


def _jax_dataset(days, model=JMP):
    return jax_get_dataset("synthetic_small", num_days=days, model=model)


def _kw(ds):
    return dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)


def _theta(batch, seed=0, model=JMP):
    return np.asarray(model.prior().sample(jax.random.PRNGKey(seed), (batch,)))


def _oracle(theta, seed, obs, kw, **extra):
    """`repro`'s oracle with the dataset scalars as run-time values."""
    names = ("population", "a0", "r0", "d0")

    def run(th, ob, *scalars):
        return jref.abc_sim_distance_ref(th, jnp.uint32(seed), ob,
                                         **dict(zip(names, scalars)), **extra)

    scalars = [jnp.float32(kw[n]) for n in names]
    return np.asarray(jax.jit(run)(jnp.asarray(theta), jnp.asarray(obs), *scalars))


def _plain(theta, seed, obs, kw, **extra):
    return ops.abc_sim_distance(torch.from_numpy(np.array(theta)), seed,
                                torch.from_numpy(np.array(obs)), **kw, **extra).numpy()


def _raises_alike(fn_port, fn_repro):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        fn_repro()
    with pytest.raises(ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ mobility and specs
@pytest.mark.parametrize("args", [
    (((1.0, 0.0), (0.0, 1.0)), 3),
    (((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)), 2),
    (((1.5, -0.5), (0.0, 1.0)), 2),
    (((0.5, 0.4), (0.0, 1.0)), 2),
])
def test_validate_mobility_errors_match_repro(args):
    _raises_alike(lambda: validate_mobility(*args), lambda: jspec.validate_mobility(*args))


@pytest.mark.parametrize("bad", ["gravity:0.1", "uniform", "ring:1.5", "identity:0.1"])
def test_make_mobility_errors_match_repro(bad):
    _raises_alike(lambda: make_mobility(bad, 4), lambda: jspec.make_mobility(bad, 4))


@pytest.mark.parametrize("grammar,n", [("identity", 3), ("uniform:0.2", 5), ("ring:0.1", 5),
                                       ("ring:0.2", 4), ("ring:0.3", 2), ("uniform:0.1", 1),
                                       ("ring:0.1", 100)])
def test_make_mobility_matches_repro(grammar, n):
    assert make_mobility(grammar, n) == jspec.make_mobility(grammar, n)


def test_regionalize_matches_repro_and_refuses_bad_matrices():
    bad = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 0.5))
    _raises_alike(lambda: regionalize(get_model("seir"), 3, bad),
                  lambda: jspec.regionalize(jax_get_model("seir"), 3, bad))
    _raises_alike(lambda: regionalize(MP, 3, seed_region=3),
                  lambda: jspec.regionalize(JMP, 3, seed_region=3))
    for args in ((MP, 100, "ring:0.1"), (get_model("seir"), 3, None),
                 (MP, 1, "identity"), (get_model("siard"), 2, "uniform:0.3")):
        t = regionalize(*args)
        j = jspec.regionalize(jax_get_model(args[0].name), *args[1:])
        for field in ("name", "n_regions", "mobility", "coupled", "seed_region",
                      "total_state", "total_transitions", "total_observed",
                      "total_observed_idx", "observed_labels", "coupled_idx",
                      "is_regional", "ctr_slots"):
            assert getattr(t, field) == getattr(j, field), (args, field)
        assert t.kernel == args[0].name  # the struct stays
    assert regionalize(MP, 100, "ring:0.1").observed_labels[:3] == ("I@r0", "R@r0", "I@r1")


def test_ctr_slots_flat_and_regional():
    for name in FLAT:
        assert get_model(name).ctr_slots == 8, name
    assert MP.ctr_slots == 16
    assert regionalize(MP, 100, "ring:0.1").ctr_slots == 304
    assert regionalize(get_model("seiard"), 2).ctr_slots == 16


def test_abc_config_mobility_validation_matches_repro():
    from repro.core.abc import ABCConfig as JaxABCConfig
    from repro.core.abc import resolved_mobility as jax_resolved

    _raises_alike(lambda: tabc.ABCConfig(batch_size=256, chunk_size=256,
                                         mobility=((0.5, 0.4), (0.0, 1.0))),
                  lambda: JaxABCConfig(mobility=((0.5, 0.4), (0.0, 1.0))))
    cfg = tabc.ABCConfig(batch_size=256, chunk_size=256, model="seir",
                         mobility=identity_mobility(2))
    jcfg = JaxABCConfig(model="seir", mobility=jspec.identity_mobility(2))
    _raises_alike(lambda: tabc.resolved_mobility(cfg, get_model("seir")),
                  lambda: jax_resolved(jcfg, jax_get_model("seir")))
    cfg = tabc.ABCConfig(batch_size=256, chunk_size=256, model=MP,
                         mobility=identity_mobility(3))
    jcfg = JaxABCConfig(model=JMP, mobility=jspec.identity_mobility(3))
    _raises_alike(lambda: tabc.resolved_mobility(cfg, MP), lambda: jax_resolved(jcfg, JMP))
    ok = tabc.ABCConfig(batch_size=256, chunk_size=256, model=MP, mobility=[[1, 0, 0, 0],
                        [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    assert tabc.resolved_mobility(ok, MP) == identity_mobility(4)


# ------------------------------------------------------------ engine rows
def _state(model, batch=256, seed=0):
    rs = np.random.default_rng(seed)
    state = rs.integers(0, 50_000, size=(batch, model.total_state)).astype(np.float32)
    noise = rs.standard_normal((batch, model.total_transitions)).astype(np.float32)
    return state, noise


@pytest.mark.parametrize("R,mobility", [(4, None), (3, "identity"), (5, "uniform:0.2")])
def test_engine_rows_match_repro(R, mobility):
    """Regional seeding exactly; hazards to rtol=1e-6 (einsum against left
    to right, f32 division of the population against the Python float's);
    one tau-leap step to a count apart."""
    t = regionalize(MP, R, mobility) if R != 4 else MP
    j = jspec.regionalize(JMP, R, mobility) if R != 4 else JMP
    theta = _theta(256, seed=R, model=j)
    cfg = dict(population=3e6, num_days=1, a0=90.0, r0=4.0, d0=2.0)
    want = np.asarray(jengine.initial_state(j, theta, jspec.EpiModelConfig(**cfg)))
    got = tengine.initial_state(t, torch.from_numpy(theta), EpiModelConfig(**cfg)).numpy()
    np.testing.assert_array_equal(got, want)
    state, noise = _state(t)
    want = np.asarray(jengine.hazards(j, state, theta, 3e6))
    got = tengine.hazards(t, torch.from_numpy(state), torch.from_numpy(theta), 3e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    want = np.asarray(jengine.tau_leap_step(j, state, theta, noise, 3e6))
    got = tengine.tau_leap_step(t, torch.from_numpy(state), torch.from_numpy(theta),
                                torch.from_numpy(noise), 3e6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0)
    assert np.mean(got == want) > 0.99
    np.testing.assert_allclose(got.sum(-1), state.sum(-1), rtol=1e-6)


def test_coupled_rows_sum_left_to_right():
    """The coupled row is mob[r][0] * x_0 + mob[r][1] * x_1 + ..., each
    product and sum rounded in float32 in that order."""
    R = 6
    t = regionalize(MP, R, "uniform:0.3")
    rs = np.random.default_rng(1)
    st = rs.integers(0, 10**7, size=(64, R, 4)).astype(np.float32)
    mob = np.asarray(t.mobility, np.float32)
    got = tengine.coupled_rows(t, torch.from_numpy(st), torch.from_numpy(mob))[0].numpy()
    want = np.empty((64, R), np.float32)
    for r in range(R):
        row = mob[r, 0] * st[:, 0, 2]
        for q in range(1, R):
            row = np.float32(row + np.float32(mob[r, q] * st[:, q, 2]))
        want[:, r] = row
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the plain version
@pytest.mark.parametrize("summary,distance", [(None, "euclidean"),
                                              ("region_pooled", "euclidean"),
                                              ("log_weekly", "mae")])
def test_plain_matches_repro_oracle_r4(summary, distance):
    """tests/test_metapop.py:235-256 on the port: repro's theta and series."""
    ds = _jax_dataset(12)
    theta = _theta(16)
    kw = _kw(ds)
    got = _plain(theta, 3, ds.observed, kw, model=MP, summary=summary, distance=distance)
    want = _oracle(theta, 3, ds.observed, kw, model=JMP, summary=summary, distance=distance)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BAR)


@pytest.mark.parametrize("R,mobility,summary", [(3, "identity", None),
                                                (6, "ring:0.2", "region_pooled"),
                                                (10, "uniform:0.1", "weekly")])
def test_plain_matches_repro_oracle_other_regions(R, mobility, summary):
    t, j = regionalize(MP, R, mobility), jspec.regionalize(JMP, R, mobility)
    ds = _jax_dataset(10, model=j)
    theta = _theta(32, seed=R, model=j)
    got = _plain(theta, 5, ds.observed, _kw(ds), model=t, summary=summary)
    want = _oracle(theta, 5, ds.observed, _kw(ds), model=j, summary=summary)
    np.testing.assert_allclose(got, want, **BAR)


def test_regionalized_flat_model_matches_repro_oracle():
    """seir regionalized without coupling: three independent copies."""
    t, j = regionalize(get_model("seir"), 3), jspec.regionalize(jax_get_model("seir"), 3)
    ds = _jax_dataset(12, model=j)
    theta = _theta(32, seed=2, model=j)
    got = _plain(theta, 7, ds.observed, _kw(ds), model=t, distance="mae")
    want = _oracle(theta, 7, ds.observed, _kw(ds), model=j, distance="mae")
    np.testing.assert_allclose(got, want, **BAR)


def test_identity_mobility_equals_independent_regions():
    """With identity mobility the R=3 trajectory is three single-region runs
    (an R=1 coupled spec) fed the matching hash-normal slots: exactly."""
    R = 3
    metapop = regionalize(MP, R, "identity")
    r1 = regionalize(MP, 1, "identity", name="metapop_r1_ref")
    cfg = EpiModelConfig(population=3e6, num_days=12, a0=90.0, r0=4.0, d0=2.0)
    theta = torch.from_numpy(_theta(8, seed=2))
    traj = tengine.simulate_observed(metapop, theta, 9, cfg)  # [B, R*2, T]
    pop_r = torch.tensor(cfg.population, dtype=torch.float32) / R
    states = []
    for r in range(R):
        seed = r == metapop.seed_region
        sub = EpiModelConfig(population=float(pop_r), num_days=cfg.num_days,
                             a0=cfg.a0 if seed else 0.0, r0=cfg.r0 if seed else 0.0,
                             d0=cfg.d0 if seed else 0.0)
        states.append(tengine.initial_state(r1, theta, sub))
    idx = torch.arange(8)
    T = metapop.n_transitions
    for day in range(cfg.num_days):
        z = krng.hash_normals(9, idx, day, metapop.total_transitions, metapop.ctr_slots)
        for r in range(R):
            states[r] = tengine.tau_leap_step(r1, states[r], theta, z[:, r * T:(r + 1) * T],
                                              pop_r)
        want = torch.cat([s[:, list(r1.observed_idx)] for s in states], dim=-1)
        assert torch.equal(traj[..., day], want), day


def test_coupling_spreads_infection():
    """Ring mobility moves mass: every region is infected by day 20; with
    identity mobility the regions other than the seeded one stay clean."""
    cfg = EpiModelConfig(population=4e6, num_days=20, a0=500.0)
    theta = torch.tensor([MP.default_theta], dtype=torch.float32)
    per_region = tengine.regional_view(tengine.simulate_observed(MP, theta, 0, cfg), MP)[0]
    final = (per_region[:, 0, -1] + per_region[:, 1, -1]).numpy()
    assert (final > 0).all(), final
    uncoupled = regionalize(MP, MP.n_regions, "identity")
    per_u = tengine.regional_view(tengine.simulate_observed(uncoupled, theta, 0, cfg),
                                  uncoupled)[0]
    final_u = (per_u[:, 0, -1] + per_u[:, 1, -1]).numpy()
    assert final_u[MP.seed_region] > 0
    assert (np.delete(final_u, MP.seed_region) == 0).all()


def test_mobility_override_is_a_runtime_value():
    """An identity override of the ring model equals the identity-
    regionalized spec bitwise and differs from the ring."""
    ds = tdata.get_dataset("synthetic_small", num_days=10, model=MP)
    theta = MP.prior().sample(8, 32)
    out = {}
    for tag, model, mob in (("override", MP, identity_mobility(4)),
                            ("ident", regionalize(MP, 4, "identity"), None), ("ring", MP, None)):
        cfg = tabc.ABCConfig(batch_size=32, chunk_size=32, num_days=10, model=model,
                             mobility=mob)
        out[tag] = tabc.make_simulator(ds, cfg, device="cpu")(theta, 2)
    assert torch.equal(out["override"], out["ident"])
    assert not torch.equal(out["ring"], out["ident"])


def test_region_pooled_is_identity_at_r1():
    ds = tdata.get_dataset("synthetic_small", num_days=10, model="seir")
    theta = get_model("seir").prior().sample(4, 32)
    got = {s: ops.abc_sim_distance(theta, 7, torch.from_numpy(ds.observed), model=get_model("seir"),
                                   summary=s, **_kw(ds))
           for s in (None, "region_pooled")}
    assert torch.equal(got[None], got["region_pooled"])


# ------------------------------------------------------------ summaries
@pytest.mark.parametrize("summary,distance", [("region_pooled", "euclidean"),
                                              ("log_weekly", "normalized_euclidean"),
                                              ("cumulative", "mae")])
def test_lower_summary_regional_matches_repro(summary, distance):
    ds = _jax_dataset(15)
    want = jsum.lower_summary(jsum.get_summary(summary), distance, ds.observed, n_regions=4)
    got = tsum.lower_summary(tsum.get_summary(summary), distance,
                             torch.from_numpy(np.array(ds.observed)), n_regions=4)
    np.testing.assert_allclose(got.obs_summary.numpy(), np.asarray(want.obs_summary),
                               rtol=1e-6)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-6)
    assert got.flags == tuple(int(f) for f in np.asarray(want.flags))
    assert got.mean_scale == float(want.mean_scale)


def test_per_region_weights_tile_and_features_match_repro():
    ds = _jax_dataset(15)
    for cls in (jsum.SummarySpec, tsum.SummarySpec):
        assert cls("w", channel_weights=(2.0, 0.5)).channel_weights == (2.0, 0.5)
    jw = jsum.lower_summary(jsum.SummarySpec("w", channel_weights=(2.0, 0.5)), "euclidean",
                            ds.observed, n_regions=4)
    tw = tsum.lower_summary(tsum.SummarySpec("w", channel_weights=(2.0, 0.5)), "euclidean",
                            torch.from_numpy(np.array(ds.observed)), n_regions=4)
    assert tw.weights.tolist() == np.asarray(jw.weights).tolist() == [2.0, 0.5] * 4
    with pytest.raises(ValueError, match="channel weights"):
        tsum.lower_summary(tsum.SummarySpec("w", channel_weights=(1.0, 1.0, 1.0)),
                           "euclidean", torch.ones(8, 5), n_regions=4)
    for summary in ("region_pooled", "weekly"):
        want = jsum.summary_features(jsum.get_summary(summary), ds.observed, 4)
        got = tsum.summary_features(tsum.get_summary(summary),
                                    torch.from_numpy(np.array(ds.observed)), 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_pool_channels_sums_regions_left_to_right():
    x = torch.tensor([[1e8, 1.0, 3.0, 2.0, -1e8, 4.0]])  # R=3, two channels
    # (1e8 + 3) rounds to 1e8 in float32 before -1e8 is added: 0, not 3
    assert tsum.pool_channels(x, 3).tolist() == [[0.0, 7.0]]
    assert tsum.pool_channels(x, 1) is x
    with pytest.raises(ValueError, match="cannot pool"):
        tsum.pool_channels(x, 4)


# ------------------------------------------------------------ data, convert, CLI
def test_regional_dataset_layout_and_convert():
    spec = regionalize(MP, 5, "ring:0.1")
    ds = tdata.get_dataset("synthetic_small", num_days=8, model=spec)
    assert ds.observed.shape == (10, 8) and ds.observed_channels[:3] == ("I@r0", "R@r0", "I@r1")
    assert ds.compatible_with(spec) and not ds.compatible_with(MP)
    assert tdata.get_dataset("synthetic_small", num_days=8, model=spec) is ds
    with pytest.raises(ValueError, match="observes"):
        tdata.get_dataset("italy", num_days=8, model=MP)
    jds = _jax_dataset(8)
    cd = convert.country_data_from_arrays("mp", jds.population, jds.a0, jds.r0, jds.d0,
                                          jds.observed, model=MP,
                                          observed_channels=jds.observed_channels)
    assert cd.observed.shape == (8, 8) and cd.compatible_with(MP)
    with pytest.raises(ValueError, match="observed must be"):
        convert.country_data_from_arrays("mp", 1e6, 1.0, 0.0, 0.0, jds.observed[:2], model=MP)
    with pytest.raises(ValueError, match="channels"):
        convert.country_data_from_arrays("mp", 1e6, 1.0, 0.0, 0.0, jds.observed, model=MP,
                                         observed_channels=("I", "R") * 4)


def test_cli_region_flags_refuse_what_repro_refuses(capsys):
    for argv, msg in ((["--regions", "0"], "--regions must be >= 1"),
                      (["--mobility", "ring:0.1"], "--mobility has no effect")):
        with pytest.raises(SystemExit):
            abc_run.main(argv + ["--device", "cpu"])
        assert msg in capsys.readouterr().err
    assert "region_pooled" in tsum.list_summaries() and "metapop_seir" in list_models()


def test_cli_100_regions_runs_on_the_cpu():
    """`--model metapop_seir --regions 100 --mobility ring:0.1` end to end."""
    post = abc_run.main(["--model", "metapop_seir", "--regions", "100", "--mobility",
                         "ring:0.1", "--dataset", "synthetic_small", "--days", "8",
                         "--batch", "256", "--chunk", "64", "--tolerance", "1e12",
                         "--accept", "8", "--max-runs", "2", "--summary", "region_pooled",
                         "--device", "cpu"])
    assert len(post) >= 8 and post.theta.shape[1] == 4
    assert np.isfinite(post.distances).all() and post.param_names == MP.param_names


def test_run_abc_recovers_truth_metapop():
    """tests/test_metapop.py:341-369 on the port, on repro's own 4-region
    series (synthetic_dataset seed 11, 15 days): every posterior-mean error
    within 0.30 of the prior width."""
    truth = JMP.default_theta
    jds = jax_synthetic_dataset(theta=truth, population=1e6, num_days=15, a0=100.0, seed=11,
                                name="recovery_metapop", model=JMP)
    ds = convert.country_data_from_arrays(jds.name, jds.population, jds.a0, jds.r0, jds.d0,
                                          jds.observed, model=MP, true_theta=truth,
                                          observed_channels=jds.observed_channels)
    pilot = tabc.ABCConfig(batch_size=4096, num_days=15, chunk_size=4096, model=MP)
    th = MP.prior().sample(5, 4096)
    d = tabc.make_simulator(ds, pilot, device="cpu")(th, 6).numpy()
    eps = float(np.quantile(d[np.isfinite(d)], 5e-3))
    cfg = dataclasses.replace(pilot, tolerance=eps, target_accepted=60, max_runs=60)
    post = tabc.run_abc(ds, cfg, seed=0, device="cpu")
    assert len(post) >= 60
    prior = MP.prior()
    width = np.asarray(prior.highs, np.float32) - np.asarray(prior.lows, np.float32)
    err = np.abs(post.theta.mean(axis=0) - np.asarray(truth)) / width
    assert (err <= 0.30).all(), err


# ------------------------------------------------------------ kernel wrapper, cost model
def test_region_axis_refuses_past_max_regions_before_any_launch():
    spec = regionalize(MP, abc_sim.MAX_REGIONS + 1, "ring:0.1")
    launches = dict(abc_sim.ENTRY_LAUNCHES)
    n = spec.total_observed
    for route in ("thread", "warp"):
        with pytest.raises(ValueError, match=f"MAX_REGIONS = {abc_sim.MAX_REGIONS}"):
            abc_sim.check_regional(spec, torch.zeros(n, 5), torch.zeros(129, 129),
                                   torch.zeros(n), 1, route)
    # past MAX_REGIONS the tile route takes R, up to its own limit
    abc_sim.check_regional(spec, torch.zeros(n, 5), torch.zeros(129, 129), torch.zeros(n), 1)
    most = abc_sim.TILE_MAX_REGIONS
    past = regionalize(MP, most + 1, "ring:0.1")
    with pytest.raises(ValueError, match=f"TILE_MAX_REGIONS = {most}"):
        abc_sim.check_regional(past, torch.zeros(past.total_observed, 5),
                               torch.zeros(most + 1, most + 1),
                               torch.zeros(past.total_observed), 1)
    big = regionalize(MP, abc_sim.MAX_REGIONS, "ring:0.1")
    with pytest.raises(ValueError, match="shared memory"):
        abc_sim.check_regional(big, torch.zeros(big.total_observed, 400),
                               torch.zeros(128, 128), torch.zeros(big.total_observed), 1)
    with pytest.raises(ValueError, match="flat"):
        abc_sim.check_regional(get_model("seir"), torch.zeros(2, 5), None, torch.zeros(2), 1)
    assert abc_sim.ENTRY_LAUNCHES == launches


def test_libraries_entries_and_symbols_follow_the_struct():
    s3 = regionalize(get_model("seir"), 3)
    assert (s3.name, s3.kernel) == ("seir_r3", "seir")
    assert abc_sim.library(s3) == "abc_sim_regional_seir"
    assert abc_sim.library(MP) == abc_sim.library("metapop_seir") == \
        "abc_sim_regional_metapop_seir"
    assert abc_sim.library("seir") == "abc_sim_seir"
    assert abc_sim.entry_name(s3, "wave") == "abc_sim_regional_wave_seir"
    assert abc_sim.entry_name(get_model("siard"), "distance") == "abc_sim_distance_siard"
    assert abc_sim.variant_symbol(MP, 8) == "abc_sim_regional_kernelI11MetapopSeirLi8EE"
    assert abc_sim.variant_symbol(regionalize(get_model("siard"), 2), 0) == \
        "abc_sim_regional_kernelI5SiardLi0EE"
    assert abc_sim.variant_symbol(get_model("siard"), 8) == "abc_sim_kernelI5SiardLi8EE"


def _lowered(model, summary=None, distance="euclidean", days=49):
    return tsum.lower_summary(tsum.get_summary(summary), distance,
                              torch.ones(model.total_observed, days), n_regions=model.n_regions)


def test_cost_model_counts_the_region_axis():
    """R=1 flat counts stay (SIARD 327 a sample-day); a region multiplies
    the per-region work, a coupled compartment adds R (2R - 1), pooling
    n_obs (R - 1) and shrinks the channels."""
    siard = get_model("siard")
    assert abc_sim.ops_per_sample_day(siard, _lowered(siard)) == pytest.approx(327 + 4 / 49)
    per_region = 60 * 3 + 5 + 1
    for R in (4, 100):
        spec = MP if R == 4 else regionalize(MP, R, "ring:0.1")
        got = abc_sim.ops_per_sample_day(spec, _lowered(spec))
        want = R * per_region + R * (2 * R - 1) + 4 * 2 * R + 4 / 49
        assert got == pytest.approx(want, rel=1e-12)
        pooled = abc_sim.ops_per_sample_day(spec, _lowered(spec, "region_pooled"))
        assert pooled == pytest.approx(R * per_region + R * (2 * R - 1) + 2 * (R - 1)
                                       + 4 * 2 + 4 / 49, rel=1e-12)
        assert abc_sim.bytes_moved(spec, 1000, 49, pool=1) == 4 * (
            4 * 1000 + 2 * R * 50 + R * R + 1000)
        assert abc_sim.bytes_moved(spec, 1000, 49, pool=R) == 4 * (
            4 * 1000 + 2 * 50 + R * R + 1000)
    s3 = regionalize(get_model("seir"), 3)
    assert abc_sim.ops_per_sample_day(s3, _lowered(s3)) == pytest.approx(
        3 * per_region + 4 * 6 + 4 / 49)
    assert abc_sim.bytes_moved(s3, 10, 49) == 4 * (4 * 10 + 6 * 50 + 10)
    assert abc_sim.bytes_moved(siard, 10, 49) == 4 * (8 * 10 + 3 * 49 + 10)


#: a regional day in cuobjdump's format: the segment loop holds the day
#: loop, whose steps are the coupled rows' R = 1 copy (0x30) and its loop
#: with the inner sum (0x60, 0x70), the regions (with the MUFU, 0xe0) and the
#: summary's pooled (0x120) and unpooled (0x150) copies
REGIONAL_SASS = """
        Function : _ZN12_GLOBAL__N_123abc_sim_regional_kernelI11MetapopSeirLi8EEEvv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FADD R1, R1, R1 ;
        /*0020*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0030*/                   FMUL R3, R3, R3 ;
        /*0040*/               @P6 BRA 0x30 ;
        /*0050*/                   BRA 0xe0 ;
        /*0060*/                   FMUL R3, R3, R3 ;
        /*0070*/                   LDL R4, [R1] ;
        /*0080*/                   LDS R5, [R2] ;
        /*0090*/                   FMUL R6, R5, R4 ;
        /*00a0*/                   FADD R7, R7, R6 ;
        /*00b0*/               @P0 BRA 0x70 ;
        /*00c0*/                   STL [R1], R7 ;
        /*00d0*/               @P1 BRA 0x60 ;
        /*00e0*/                   MUFU.LG2 R8, R8 ;
        /*00f0*/                   FFMA R9, R9, R9, R9 ;
        /*0100*/                   LOP3.LUT R10, R10, R10, RZ, 0x96, !PT ;
        /*0110*/               @P2 BRA 0xe0 ;
        /*0120*/                   LDL R11, [R1] ;
        /*0130*/               @P3 BRA 0x120 ;
        /*0140*/                   BRA 0x190 ;
        /*0150*/                   LDL R11, [R1] ;
        /*0160*/                   LDL R12, [R1+0x4] ;
        /*0170*/                   FADD R11, R11, R12 ;
        /*0180*/               @P3 BRA 0x150 ;
        /*0190*/                   IADD3 R12, R12, 0x1, RZ ;
        /*01a0*/               @P4 BRA 0x20 ;
        /*01b0*/                   IADD3 R13, R13, 0x1, RZ ;
        /*01c0*/               @P5 BRA 0x10 ;
        /*01d0*/                   EXIT ;
"""


def test_regional_census_counts_each_step():
    funcs = sass.parse_functions(REGIONAL_SASS)
    body = next(iter(funcs.values()))
    cen = sass.regional_census(body, coupled=True)
    assert cen["shape_ok"]
    assert cen["coupled_sum"]["total"] == 5  # 0x70..0xb0
    assert cen["coupled_rows"]["total"] == 3  # 0x60, 0xc0, 0xd0
    assert cen["regions"]["total"] == 4 and cen["regions"]["quarter"] == 1
    assert cen["channels"]["total"] == 4 and cen["channels_span"] == ["0150", "0180"]
    assert sass.regional_census(body, coupled=True, pooled=True)["channels"]["total"] == 2
    per_day = sass.regional_per_day(cen, 4, 4)
    assert per_day["total"] == cen["day"]["total"] + 4 * 3 + 12 * 5 + 4 * 4 + 4 * 4
    floor = sass.regional_issue_floor_ms(cen, 4, 4, 100_000, 49, 132, 1980.0)
    assert floor["instructions_per_sample_day"] == pytest.approx(
        per_day["total"] + cen["per_sample_outside_loop"]["total"] / 49)
    # an uncoupled model has no loop with an inner loop before its regions
    assert sass.regional_census(body, coupled=False)["shape_ok"]
    bad = sass.regional_census(sass.parse_functions(REGIONAL_SASS.replace("MUFU.LG2", "FMUL"))
                               [next(iter(funcs))], coupled=True)
    assert not bad["shape_ok"]
    assert sass.regional_issue_floor_ms(bad, 4, 4, 100_000, 49, 132, 1980.0) is None


# ------------------------------------------------------------ the flat pins stay
@pytest.mark.parametrize("name", FLAT)
def test_flat_pins_stay_bitwise(name):
    """The region axis leaves every flat stream as it was: the plain version
    equals `{model}/pallas` of tests/data/r1_pins.npz bit for bit."""
    import os

    pins = np.load(os.path.join(os.path.dirname(__file__), "data", "r1_pins.npz"))
    got = ops.abc_sim_distance(
        torch.from_numpy(np.array(pins[f"{name}/theta"])), 123,
        torch.from_numpy(np.array(pins[f"{name}/observed"])), model=get_model(name),
        population=1e6, a0=100.0, r0=0.0, d0=0.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  pins[f"{name}/pallas"].astype(np.float32).view(np.uint32))
