"""The port's NPE pieces (`repro_torch.core.npe`, `optim.adamw`,
`models.common.layer_norm`/`vanilla_mlp`, `epi.engine.simulate_features`)
held against `repro` on the CPU.

Same numpy inputs (seeded) through both packages: the layers at rtol 1e-5,
atol 1e-6; five AdamW steps through the warmup and one clipped gradient at
rtol 1e-6, atol 1e-7; the MDN's forward and log-density on `repro`'s own
`mdn_init` weights (carried by `convert.mdn_params_from_arrays`) at rtol
1e-5, atol 1e-5; the loss at rtol 1e-4 and its gradients against
`jax.value_and_grad` of `repro`'s loss at rtol 1e-4 with an atol set by
float32 rounding itself (see `test_loss_and_gradients_match_repro`).
Estimator files cross both ways, `log_prob` equal at rtol 1e-5 with the
forward's atol 1e-5 (a log-density crosses 0, where a relative bar alone
compares float32 rounding of a difference of large terms). Draws come from the port's counter hash,
not threefry, so `sample_posterior` is held to `repro`'s draws at the same
weights by statistics. Then `tests/test_npe.py`'s mechanics: validation,
refusals, summary features, persistence and fine-tuning.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import npe as jnpe
from repro.core.abc import ABCConfig as JaxABCConfig
from repro.core.summaries import SummarySpec as JaxSummarySpec
from repro.core.summaries import summary_features as jax_summary_features
from repro.epi import engine as jengine
from repro.epi.data import synthetic_dataset as jax_synthetic_dataset
from repro.epi.models import get_model as jax_get_model
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.core import npe as tnpe
from repro_torch.core.abc import ABCConfig, ABCState, make_simulator, run_abc
from repro_torch.core.npe import NPEConfig, NPEstimator, fine_tune, train_npe
from repro_torch.core.serving import EpiServer, ServeConfig
from repro_torch.core.summaries import (
    SummarySpec,
    apply_summary,
    flush_columns,
    get_summary,
    summary_features,
)
from repro_torch.epi import engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import EpiModelConfig
from repro_torch.models import common as tcommon
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

DAYS = 12
TINY = NPEConfig(train_steps=25, train_batch=64, n_pilot=64, hidden=32,
                 n_components=3, fine_tune_steps=4)
JAX_TINY = jnpe.NPEConfig(**dataclasses.asdict(TINY))


def _jax_dataset(name="npe_unit", seed=3, scale=1.0):
    ds = jax_synthetic_dataset(theta=(0.5, 0.2, 1.0), population=1e6, num_days=DAYS,
                               a0=100.0, seed=seed, name=name, model="sir")
    if scale != 1.0:
        ds = dataclasses.replace(ds, observed=(ds.observed * scale).astype(np.float32))
    return ds


def _dataset(name="npe_unit", seed=3, scale=1.0):
    """`repro`'s threefry series as the port's CountryData (both packages
    condition on the same numbers)."""
    j = _jax_dataset(name, seed, scale)
    return convert.country_data_from_arrays(j.name, j.population, j.a0, j.r0, j.d0,
                                            j.observed, true_theta=j.true_theta, model="sir")


def _cfg(**kw):
    base = dict(num_days=DAYS, backend="npe", model="sir", target_accepted=32, npe=TINY)
    base.update(kw)
    return ABCConfig(**base)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def trained():
    """One tiny estimator trained by the port on the CPU."""
    return train_npe(_dataset(), _cfg(), seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_trained():
    """One tiny estimator trained by `repro` (threefry, XLA on the CPU)."""
    cfg = JaxABCConfig(num_days=DAYS, backend="npe", model="sir", target_accepted=32,
                       npe=JAX_TINY)
    return jnpe.train_npe(_jax_dataset(), cfg, key=0)


# ------------------------------------------------------------------ layers
def test_layer_norm_and_vanilla_mlp_match_repro():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 16)).astype(np.float32) * 3 + 1
    s, b = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    w1, b1 = rng.normal(size=(16, 32)).astype(np.float32), rng.normal(size=32).astype(np.float32)
    w2, b2 = rng.normal(size=(32, 16)).astype(np.float32), rng.normal(size=16).astype(np.float32)
    j = [jnp.asarray(v) for v in (x, s, b, w1, b1, w2, b2)]
    t = [torch.from_numpy(v) for v in (x, s, b, w1, b1, w2, b2)]
    np.testing.assert_allclose(_np(tcommon.layer_norm(*t[:3])),
                               np.asarray(jcommon.layer_norm(*j[:3])), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tcommon.vanilla_mlp(t[0], *t[3:])),
                               np.asarray(jcommon.vanilla_mlp(j[0], *j[3:])),
                               rtol=1e-5, atol=1e-6)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True; torch's exact GELU differs
    by up to ~5e-4 and would fail the bar above."""
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    got = _np(tcommon.vanilla_mlp(x[:, None], torch.ones(1, 1), torch.zeros(1),
                                  torch.ones(1, 1), torch.zeros(1)))[:, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(_np(F.gelu(x)) - want).max() > 1e-4


# ------------------------------------------------------------------- AdamW
def _opt_tree(rng, scale=1.0):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32) * scale,
            "blocks": ({"b": rng.normal(size=(3,)).astype(np.float32) * scale,
                        "a": rng.normal(size=(2, 2)).astype(np.float32) * scale},),
            "z": rng.normal(size=(5,)).astype(np.float32) * scale}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as(v, fn) for v in tree)
    return fn(tree)


def test_adamw_five_steps_match_repro():
    """Five steps through a warmup of 3, the third with a gradient norm far
    above clip_norm; params, both moments, the step and the metrics each
    step at rtol 1e-6, atol 1e-7."""
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=3, total_steps=10)
    tcfg = tadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=3, total_steps=10)
    jp, tp = _as(params, jnp.asarray), _as(params, torch.from_numpy)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(5):
        grads = _opt_tree(rng, scale=50.0 if i == 2 else 0.05)
        jp, js, jm = jadamw.adamw_update(jp, _as(grads, jnp.asarray), js, jcfg)
        tp, ts, tm = tadamw.adamw_update(tp, _as(grads, torch.from_numpy), ts, tcfg)
        assert float(jm["grad_norm"]) > 1.0 if i == 2 else float(jm["grad_norm"]) < 1.0
        for a, b in zip(jax.tree.leaves((jp, js["mu"], js["nu"])),
                        tadamw.tree_leaves((tp, ts["mu"], ts["nu"]))):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_repro():
    for cfg in (dict(lr=3e-3, warmup_steps=15, total_steps=300),
                dict(lr=1e-3, warmup_steps=1, total_steps=1)):
        j, t = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
        for step in (0, 1, 7, 15, 16, 150, 299, 300, 400):
            np.testing.assert_allclose(
                float(tadamw.cosine_schedule(t, torch.tensor(step, dtype=torch.int32))),
                float(jadamw.cosine_schedule(j, jnp.asarray(step, jnp.int32))),
                rtol=1e-6, atol=1e-9)


def test_tree_helpers_walk_dicts_in_sorted_key_order():
    tree = {"z": torch.zeros(1), "blocks": ({"w2": torch.ones(1), "b1": torch.full((1,), 2.0)},),
            "a": torch.full((1,), 3.0)}
    assert [float(x) for x in tadamw.tree_leaves(tree)] == [3.0, 2.0, 1.0, 0.0]
    back = tadamw.tree_unflatten(tree, [torch.full((1,), float(i)) for i in range(4)])
    assert list(back) == ["z", "blocks", "a"] and float(back["blocks"][0]["b1"]) == 1.0
    assert isinstance(back["blocks"], tuple)


# --------------------------------------------------------------------- MDN
F_IN, P = 24, 3


def _repro_mdn(seed=1):
    jp = jnpe.mdn_init(jax.random.PRNGKey(seed), F_IN, P, JAX_TINY)
    tp = convert.mdn_params_from_arrays([np.asarray(x) for x in jax.tree.leaves(jp)], TINY,
                                        F_IN, P)
    return jp, tp


def _mdn_inputs(seed=2, batch=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, F_IN)).astype(np.float32),
            rng.uniform(size=(batch, P)).astype(np.float32))


def test_mdn_tree_is_repro_tree():
    """Leaf order, names and shapes are `jax.tree.leaves` of repro's
    `mdn_init`; the port's own init has repro's deterministic leaves
    (ones, zeros, the spread head bias) and the same scale of normals."""
    jp, _ = _repro_mdn()
    template = tnpe.mdn_template(F_IN, P, TINY)
    assert [tuple(t.shape) for t in tadamw.tree_leaves(template)] == [
        tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert len(tadamw.tree_leaves(template)) == 6 * TINY.n_layers + 4
    own = tnpe.mdn_init(5, F_IN, P, TINY)
    for name in ("head_b", "in_b"):
        np.testing.assert_array_equal(_np(own[name]), np.asarray(jp[name]))
    for key in ("ln_s", "ln_b", "b1", "b2"):
        np.testing.assert_array_equal(_np(own["blocks"][1][key]), np.asarray(jp["blocks"][1][key]))
    for key, fan_in in (("in_w", F_IN), ("head_w", TINY.hidden)):
        assert abs(float(own[key].std()) * np.sqrt(fan_in) - 1.0) < 0.15
    again = tnpe.mdn_init(5, F_IN, P, TINY)
    assert all(torch.equal(a, b) for a, b in zip(tadamw.tree_leaves(own),
                                                 tadamw.tree_leaves(again)))


def test_mdn_forward_and_log_prob_match_repro():
    jp, tp = _repro_mdn()
    x, th = _mdn_inputs()
    got = tnpe.mdn_forward(tp, torch.from_numpy(x), TINY, P)
    want = jnpe.mdn_forward(jp, jnp.asarray(x), JAX_TINY, P)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tnpe.mdn_log_prob(tp, torch.from_numpy(x), torch.from_numpy(th), TINY, P)),
        np.asarray(jnpe.mdn_log_prob(jp, jnp.asarray(x), jnp.asarray(th), JAX_TINY, P)),
        rtol=1e-5, atol=1e-5)


def _f64_loss(params, x, th, cfg, p):
    """A float64 evaluation of the loss, written out from repro's formulas
    (the arbiter of float32 rounding below)."""
    K = cfg.n_components
    h = F.gelu(x @ params["in_w"] + params["in_b"], approximate="tanh")
    for blk in params["blocks"]:
        mu = h.mean(-1, keepdim=True)
        var = h.var(-1, keepdim=True, unbiased=False)
        ln = (h - mu) * torch.rsqrt(var + 1e-5) * blk["ln_s"] + blk["ln_b"]
        h = h + F.gelu(ln @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"] + blk["b2"]
    out = h @ params["head_w"] + params["head_b"]
    log_pi = torch.log_softmax(out[:, :K], -1)
    m = 0.5 + out[:, K:K + K * p].reshape(-1, K, p)
    sg = cfg.sigma_min + F.softplus(out[:, K + K * p:].reshape(-1, K, p) - 0.4328)
    z = (th[:, None, :] - m) / sg
    comp = -0.5 * (z * z).sum(-1) - torch.log(sg).sum(-1) - 0.5 * p * np.log(2 * np.pi)
    return -torch.logsumexp(log_pi + comp, -1).mean()


def test_loss_and_gradients_match_repro():
    """The training loss and every gradient from autograd against
    `jax.value_and_grad` of repro's loss on the same weights and inputs.

    The loss meets rtol 1e-4 (it agrees to a few ulps). The gradients meet
    rtol 1e-4 with an atol of 4x the float32 rounding of repro's own
    gradient, measured against a float64 evaluation of the same formulas:
    at this width (hidden 32, 24 features, batch 64) each package's float32
    gradient is up to ~7e-6 from float64 (about 1e-6 is the floor of a
    gradient element built from 64 samples of O(1) terms), so an atol of
    1e-6 would compare two rounding errors, not two formulas. The port's
    own gradient must be as close to float64 as repro's (within 2x)."""
    jp, tp = _repro_mdn()
    x, th = _mdn_inputs()

    def jloss(p):
        return -jnp.mean(jnpe.mdn_log_prob(p, jnp.asarray(x), jnp.asarray(th), JAX_TINY, P))

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = [t.requires_grad_(True) for t in tadamw.tree_leaves(tp)]
    tl = -torch.mean(tnpe.mdn_log_prob(tadamw.tree_unflatten(tp, leaves), torch.from_numpy(x),
                                       torch.from_numpy(th), TINY, P))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    l64 = [t.detach().double().requires_grad_(True) for t in tadamw.tree_leaves(tp)]
    g64 = torch.autograd.grad(
        _f64_loss(tadamw.tree_unflatten(tp, l64), torch.from_numpy(x).double(),
                  torch.from_numpy(th).double(), TINY, P), l64)
    jg = [np.asarray(g, np.float64) for g in jax.tree.leaves(jg)]
    tg = [_np(g).astype(np.float64) for g in tg]
    g64 = [_np(g) for g in g64]
    repro_err = max(np.abs(a - c).max() for a, c in zip(jg, g64))
    port_err = max(np.abs(b - c).max() for b, c in zip(tg, g64))
    assert 0 < repro_err < 2e-5, repro_err
    assert port_err <= 2 * repro_err, (port_err, repro_err)
    assert len(tg) == len(jg) == 16
    for b, a in zip(tg, jg):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=4 * repro_err)


# ------------------------------------------------------ summary features
def test_flush_columns_layout():
    np.testing.assert_array_equal(flush_columns(12, 5), [4, 9, 11])
    np.testing.assert_array_equal(flush_columns(10, 5), [4, 9])
    np.testing.assert_array_equal(flush_columns(4, 1), [0, 1, 2, 3])


def test_summary_features_identity_is_flat_series():
    ds = _dataset()
    feats = _np(summary_features(get_summary(None), torch.from_numpy(ds.observed), 1))
    np.testing.assert_allclose(feats, ds.observed.reshape(-1), rtol=1e-6)


@pytest.mark.parametrize("summary", [None, "log_weekly", "cum5"])
def test_summary_features_match_abc_flush_values_and_repro(summary):
    """Binned summaries condition on the bin-closing columns of
    apply_summary, and on the same numbers as repro's features."""
    spec = (SummarySpec(name="cum5", cumulative=True, bin_days=5) if summary == "cum5"
            else get_summary(summary))
    jspec = JaxSummarySpec(**dataclasses.asdict(spec))
    ds = _dataset()
    obs = torch.from_numpy(ds.observed)
    feats = _np(summary_features(spec, obs, 1))
    full = _np(apply_summary(spec, obs))
    np.testing.assert_allclose(feats, full[:, flush_columns(DAYS, spec.bin_days)].reshape(-1),
                               rtol=1e-6)
    np.testing.assert_allclose(feats, np.asarray(jax_summary_features(jspec, ds.observed, 1)),
                               rtol=1e-6)


@pytest.mark.parametrize("model,summary", [("sir", None), ("seir", "cum5"),
                                           ("siard", "log_weekly")])
def test_simulate_features_is_summary_of_simulate_observed(model, summary):
    """simulate_features is summary_features of simulate_observed on the
    same stream, bitwise, in repro's feature layout ([B, n_chan * n_bins])."""
    spec = get_model(model)
    summ = SummarySpec(name="cum5", cumulative=True, bin_days=5) if summary == "cum5" else summary
    theta = spec.prior().sample(3, 16)
    mcfg = EpiModelConfig(population=1e6, num_days=DAYS, a0=100.0, r0=0.0, d0=0.0)
    got = engine.simulate_features(spec, theta, 9, mcfg, summary=summ)
    sim = engine.simulate_observed(spec, theta, 9, mcfg)
    assert torch.equal(got, summary_features(get_summary(summ), sim, spec.n_regions))
    jsumm = (JaxSummarySpec(**dataclasses.asdict(get_summary(summ))) if summ is not None
             else None)
    want = jengine.simulate_features(jax_get_model(model), jnp.asarray(_np(theta)),
                                     jax.random.PRNGKey(0), mcfg, summary=jsumm)
    assert tuple(got.shape) == want.shape


# ------------------------------------------------------------- persistence
def test_repro_estimator_loads_in_the_port(tmp_path, jax_trained):
    path = str(tmp_path / "repro.npz")
    jax_trained.save(path)
    est = NPEstimator.load(path, device="cpu")
    assert (est.model, est.num_days, est.param_names) == ("sir", DAYS, tuple(jax_trained.param_names))
    assert est.param_names == get_model("sir").param_names
    assert est.npe == TINY and est.train_sims == jax_trained.train_sims
    for a, b in zip(tadamw.tree_leaves(est.params), jax.tree.leaves(jax_trained.params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    obs = _jax_dataset().observed
    theta = np.asarray(jax_trained.sample_posterior(obs, 64, key=3).theta)
    np.testing.assert_allclose(est.log_prob(obs, theta), jax_trained.log_prob(obs, theta),
                               rtol=1e-5, atol=1e-5)


def test_port_estimator_loads_in_repro(tmp_path, trained):
    path = str(tmp_path / "port.npz")
    trained.save(path)
    back = jnpe.NPEstimator.load(path)
    assert back.model == "sir" and back.param_names == trained.param_names
    assert back.npe == JAX_TINY and back.train_sims == trained.train_sims
    obs = _dataset().observed
    theta = trained.sample_posterior(obs, 64, seed=5).theta
    np.testing.assert_allclose(np.asarray(back.log_prob(obs, theta)),
                               trained.log_prob(obs, theta), rtol=1e-5, atol=1e-5)


def test_estimator_save_load_roundtrip(tmp_path, trained):
    ds = _dataset()
    path = str(tmp_path / "est.npz")
    trained.save(path)
    back = NPEstimator.load(path, device="cpu")
    assert back.model == "sir" and back.num_days == DAYS
    assert back.param_names == trained.param_names
    assert back.train_sims == trained.train_sims and back.final_loss == trained.final_loss
    a = trained.sample_posterior(ds.observed, 64, seed=5)
    b = back.sample_posterior(ds.observed, 64, seed=5)
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.distances, b.distances)


def test_estimator_load_rejects_corrupt_file(tmp_path, trained):
    path = tmp_path / "bad.npz"
    path.write_bytes(b"not an npz at all")
    with pytest.raises(ValueError, match="corrupt"):
        NPEstimator.load(str(path), device="cpu")
    with pytest.raises(FileNotFoundError):
        NPEstimator.load(str(tmp_path / "missing.npz"), device="cpu")
    # a file cut short by a crash mid-write
    good = tmp_path / "good.npz"
    trained.save(str(good))
    cut = tmp_path / "cut.npz"
    cut.write_bytes(good.read_bytes()[: good.stat().st_size // 2])
    with pytest.raises(ValueError, match="corrupt"):
        NPEstimator.load(str(cut), device="cpu")
    # leaves that do not fit the config
    z = dict(np.load(good))
    z["leaf_000"] = np.zeros((3,), np.float32)
    np.savez(tmp_path / "shape.npz", **z)
    with pytest.raises(ValueError, match="leaf shape"):
        NPEstimator.load(str(tmp_path / "shape.npz"), device="cpu")


def test_save_is_atomic(tmp_path, trained, monkeypatch):
    """A save that fails part-way leaves the previous file as it was."""
    path = tmp_path / "est.npz"
    trained.save(str(path))
    before = path.read_bytes()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        trained.save(str(path))
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["est.npz"]


def test_estimator_rejects_wrong_observed_shape(trained):
    with pytest.raises(ValueError, match="days"):
        trained.features_of(np.zeros((2, DAYS - 3), np.float32))
    with pytest.raises(ValueError, match="features"):
        trained.features_of(np.zeros((5, DAYS), np.float32))


# ---------------------------------------------------------------- sampling
def test_sample_posterior_matches_repro_draws_in_distribution(tmp_path, jax_trained):
    """20,000 draws of the port and of repro at repro's weights: each
    parameter's mean within 0.02 and its 5% and 95% quantiles within 0.03
    of the prior width (the two streams differ: counter hash vs threefry)."""
    path = str(tmp_path / "repro.npz")
    jax_trained.save(path)
    est = NPEstimator.load(path, device="cpu")
    obs = _jax_dataset().observed
    got = est.sample_posterior(obs, 20_000, seed=1)
    want = jax_trained.sample_posterior(obs, 20_000, key=1)
    width = est.highs - est.lows
    assert got.theta.shape == want.theta.shape == (20_000, 3)
    assert (np.abs(got.theta.mean(0) - want.theta.mean(0)) / width <= 0.02).all()
    for q in (0.05, 0.95):
        dq = np.abs(np.quantile(got.theta, q, axis=0) - np.quantile(want.theta, q, axis=0))
        assert (dq / width <= 0.03).all(), (q, dq / width)
    # the densities of the draws agree too: repro's own log-density of the
    # port's draws is their -distance
    np.testing.assert_allclose(-got.distances[:256],
                               np.asarray(jax_trained.log_prob(obs, got.theta[:256])),
                               rtol=1e-4, atol=1e-4)


def test_mixture_draw_picks_components_by_weight():
    """mdn_sample's inverse-CDF component pick follows exp(log_pi): with a
    head that fixes the logits, component shares match the weights."""
    cfg = NPEConfig(hidden=4, n_layers=0, n_components=3)
    params = tnpe.mdn_init(0, 2, 1, cfg)
    params["in_w"] = torch.zeros_like(params["in_w"])
    params["head_w"] = torch.zeros_like(params["head_w"])
    hb = params["head_b"].clone()
    hb[:3] = torch.log(torch.tensor([0.2, 0.5, 0.3]))
    hb[3:6] = torch.tensor([-0.4, 0.0, 0.4])  # means 0.1, 0.5, 0.9
    hb[6:9] = -20.0  # sigmas ~ sigma_min
    params["head_b"] = hb
    draws = tnpe.mdn_sample(params, torch.zeros(2), 11, 30_000, cfg, 1)[:, 0]
    shares = [float(((draws - m).abs() < 0.05).float().mean()) for m in (0.1, 0.5, 0.9)]
    np.testing.assert_allclose(shares, [0.2, 0.5, 0.3], atol=0.01)


def test_posterior_contract_from_sampler(trained):
    ds = _dataset()
    post = trained.sample_posterior(ds.observed, 40, seed=2)
    assert post.theta.shape == (40, 3)
    assert np.isfinite(post.distances).all()
    assert post.tolerance == 0.0 and post.runs == 0
    assert post.simulations == trained.train_sims == TINY.n_pilot + 25 * 64
    lo, hi = np.asarray(trained.lows), np.asarray(trained.highs)
    assert (post.theta >= lo - 1e-6).all() and (post.theta <= hi + 1e-6).all()
    top = post.top(5)
    assert np.all(np.sort(post.distances)[:5] == np.sort(top.distances))


# -------------------------------------------------------------- validation
@pytest.mark.parametrize("kw", [dict(train_steps=0), dict(train_batch=1),
                                dict(n_components=0), dict(hidden=0), dict(n_layers=-1),
                                dict(fine_tune_steps=-1), dict(sigma_min=0.0)])
def test_npe_config_errors_are_repros(kw):
    with pytest.raises(ValueError) as want:
        jnpe.NPEConfig(**kw)
    with pytest.raises(ValueError) as got:
        NPEConfig(**kw)
    assert str(got.value) == str(want.value)


def test_npe_config_defaults_are_repros():
    assert dataclasses.asdict(NPEConfig()) == dataclasses.asdict(jnpe.NPEConfig())
    assert (tnpe._SIGMA0, tnpe._PILOT_SALT, tnpe._SAMPLE_SALT) == (
        jnpe._SIGMA0, jnpe._PILOT_SALT, jnpe._SAMPLE_SALT)
    assert tnpe.resolve_npe_config(None) == NPEConfig()
    with pytest.raises(TypeError, match="NPEConfig"):
        tnpe.resolve_npe_config({"train_steps": 3})


def test_abc_config_npe_field_validation():
    with pytest.raises(TypeError, match="NPEConfig"):
        ABCConfig(backend="npe", npe={"train_steps": 10})
    with pytest.raises(ValueError, match="backend"):
        ABCConfig(backend="cuda", npe=TINY)
    with pytest.raises(ValueError, match="backend"):
        ABCConfig(backend="xla_fused")
    assert ABCConfig(backend="npe").npe is None


def test_make_simulator_rejects_npe():
    with pytest.raises(ValueError, match="amortized"):
        make_simulator(_dataset(), _cfg(), device="cpu")


def test_run_abc_npe_rejects_wave_machinery():
    ds = _dataset()
    with pytest.raises(ValueError, match="waves"):
        run_abc(ds, _cfg(), seed=0, state=ABCState(), device="cpu")
    with pytest.raises(ValueError, match="waves"):
        run_abc(ds, _cfg(), seed=0, wave_runner=object(), device="cpu")


def test_serve_config_validates_npe_fields():
    with pytest.raises(ValueError, match="fit_backend"):
        ServeConfig(fit_backend="mcmc")
    with pytest.raises(ValueError, match="npe"):
        ServeConfig(fit_backend="smc", npe=TINY)
    with pytest.raises(TypeError, match="NPEConfig"):
        ServeConfig(fit_backend="npe", npe=object())
    assert ServeConfig(fit_backend="npe").npe is None


def test_npe_entry_points_refuse_a_missing_card(monkeypatch, trained, tmp_path):
    """train_npe, run_npe (and run_abc's npe dispatch), the NPE server and
    `load` take the card unless asked for the CPU; without one they raise
    before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = _dataset()
    with pytest.raises(RuntimeError, match="cuda"):
        train_npe(ds, _cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        tnpe.run_npe(ds, _cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        run_abc(ds, _cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        EpiServer(ServeConfig(fit_backend="npe", npe=TINY))
    trained.save(str(tmp_path / "e.npz"))
    with pytest.raises(RuntimeError, match="cuda"):
        NPEstimator.load(str(tmp_path / "e.npz"))


# --------------------------------------------------------------- fine-tune
def test_fine_tune_zero_steps_is_identity(trained):
    assert fine_tune(trained, _dataset(), seed=1, steps=0) is trained


def test_fine_tune_updates_weights_and_accounting(trained):
    before = [t.clone() for t in tadamw.tree_leaves(trained.params)]
    ft = fine_tune(trained, _dataset(scale=1.05), seed=1, steps=3)
    assert ft is not trained
    assert ft.train_steps_done == trained.train_steps_done + 3
    assert ft.train_sims == trained.train_sims + 3 * TINY.train_batch
    np.testing.assert_array_equal(ft.feat_mean, trained.feat_mean)
    np.testing.assert_array_equal(ft.feat_std, trained.feat_std)
    assert any(not torch.equal(a, b) for a, b in zip(tadamw.tree_leaves(ft.params),
                                                     tadamw.tree_leaves(trained.params)))
    # the estimator fine-tuned from is left as it was
    assert all(torch.equal(a, b) for a, b in zip(before, tadamw.tree_leaves(trained.params)))
    again = fine_tune(trained, _dataset(scale=1.05), seed=1, steps=3)
    assert all(torch.equal(a, b) for a, b in zip(tadamw.tree_leaves(ft.params),
                                                 tadamw.tree_leaves(again.params)))


def test_fine_tune_rejects_incompatible_channels(trained):
    j = jax_synthetic_dataset(theta=(0.2, 0.4, 6.0, 0.1, 0.05, 0.01, 0.02, 1.0),
                              population=1e6, num_days=DAYS, a0=100.0, seed=3, name="wrong",
                              model="siard")
    siard_ds = convert.country_data_from_arrays(j.name, j.population, j.a0, j.r0, j.d0,
                                                j.observed, model="siard")
    with pytest.raises(ValueError, match="trained for"):
        fine_tune(trained, siard_ds, seed=1, steps=1)


def test_fine_tune_builds_its_step_without_mobility(trained, monkeypatch):
    """As in repro: fine_tune passes no mobility override to its step."""
    seen = []
    real = tnpe._make_train_step

    def spy(spec, prior, mcfg, schedule, summary, mobility, *rest):
        seen.append(mobility)
        return real(spec, prior, mcfg, schedule, summary, mobility, *rest)

    monkeypatch.setattr(tnpe, "_make_train_step", spy)
    fine_tune(trained, _dataset(), seed=1, steps=1)
    assert seen == [None]


def test_npe_demo_configs_are_repros():
    """configs/epi_abc.py's npe_demo and npe_serving_demo carry repro's
    sizes (the port's simulation backend in place of xla_fused)."""
    from repro.configs import epi_abc as jconfigs
    from repro_torch.configs import epi_abc as tconfigs

    for args in ((), ("seir", 20)):
        got, want = tconfigs.npe_demo(*args), jconfigs.npe_demo(*args)
        assert (got.name, got.dataset) == (want.name, want.dataset)
        for field in ("target_accepted", "num_days", "backend", "model"):
            assert getattr(got.abc, field) == getattr(want.abc, field), field
        assert dataclasses.asdict(got.abc.npe) == dataclasses.asdict(want.abc.npe)
        assert got.load_dataset().observed.shape == want.load_dataset().observed.shape
    got, want = tconfigs.npe_serving_demo("s", "d"), jconfigs.npe_serving_demo("s", "d")
    for field in ("slots", "forecast_particles", "fit_backend", "store_dir", "data_dir"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("n_particles", "batch_size", "n_rounds", "quantile", "num_days", "model"):
        assert getattr(got.fit, field) == getattr(want.fit, field), field
    assert dataclasses.asdict(got.npe) == dataclasses.asdict(want.npe)
