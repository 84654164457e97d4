"""The port's LM training path on the CPU, held against `repro`: the data
pipeline, gradient compression, AdamW on bf16 parameters, the train step
(`launch.steps`), checkpoint resume and the training CLI (`launch.train`).

Bars, and why:
  * pipeline batches and compression: bitwise (pure numpy; the quantizer
    and its residual computed as `jax.jit` compiles them, with XLA's fmas).
  * AdamW on a bf16 tree: the float32 moments within rtol 1e-6 and 1e-6 of
    the leaf's largest |value| (the same float32 operations, but XLA fuses
    a product and a sum into one fma, and b1 mu + (1 - b1) g cancels), and
    the bf16 parameters within one bf16 step (2^-7 relative): a moment one
    float32 ulp apart may round the updated parameter the other way.
  * the residual of the quantizer: half a float32 ulp of the exact float64
    value (repro's test_optim.py compares it with g - deq, two roundings).
  * the train step against `repro`'s `build_train_step` on a one-device host
    mesh: loss rtol 1e-3 and grad norm rtol 1e-2 (tests/test_torch_train_
    families.py's bars); the first moment mu = (1 - b1) * scale * g, so each
    leaf within 8 bf16 steps of the gradient's largest |value| times
    (1 - b1) * scale; the updated parameters within 2 lr + one bf16 step: at
    step 1 AdamW moves a parameter by lr * (g / |g| + wd p), so an element
    whose gradient sign differs (a gradient near 0) moves 2 lr apart.
  * resume: tests/test_checkpoint.py:73's bar (rtol 1e-5, atol 1e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticTokenDataset as JDataset
from repro.launch import shapes as jshapes
from repro.launch.mesh import make_host_mesh, set_mesh_compat
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models.registry import get_model as jget_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.compress import compress_gradients as jcompress
from repro.optim.compress import decompress_gradients as jdecompress
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_arrays, params_to_arrays
from repro_torch.data import SyntheticTokenDataset, make_batches
from repro_torch.kernels.ops import FlashBackwardError
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import get_model, list_archs
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                               compress_gradients, decompress_gradients)
from repro_torch.optim.adamw import tree_leaves, tree_map

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(a):
    a = np.ascontiguousarray(np.atleast_1d(a))
    return a.view(np.uint8)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (1, 7, 0, 1), (3, 2, 1, 2), (5, 11, 3, 4), (2**40, 2**33, 5, 8)])
def test_pipeline_batches_are_repro_bitwise(seed, step, shard, n_shards):
    want = JDataset(vocab=512, seq_len=24, seed=seed).batch(step, 8, shard, n_shards)
    got = SyntheticTokenDataset(vocab=512, seq_len=24, seed=seed).batch(step, 8, shard, n_shards)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == np.int32 and got[k].shape == (8 // n_shards, 24)
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    stream = list(make_batches(SyntheticTokenDataset(512, 24, seed), 8, 3))
    np.testing.assert_array_equal(stream[2]["tokens"],
                                  JDataset(512, 24, seed).batch(2, 8)["tokens"])
    with pytest.raises(ValueError, match="shards"):
        SyntheticTokenDataset(512, 24).batch(0, 6, 0, 4)


# ------------------------------------------------------------ compression
def _grad_trees(rng, scale):
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32) * scale,
         "layers": [rng.normal(size=(7,)).astype(np.float32), np.zeros(3, np.float32)]}
    e = {"w": rng.normal(size=(64, 64)).astype(np.float32) * 1e-3 * scale,
         "layers": [rng.normal(size=(7,)).astype(np.float32) * 1e-3, np.zeros(3, np.float32)]}
    return g, e


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_compression_is_jitted_repro_bitwise(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 10))
    g, e = _grad_trees(rng, scale)
    (jcomp, jerr) = jax.jit(jcompress)(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    tcomp, terr = compress_gradients(tree_map(torch.from_numpy, g), tree_map(torch.from_numpy, e))
    jdeq, tdeq = jax.jit(jdecompress)(jcomp), decompress_gradients(tcomp)
    for want, got in ((jcomp["q"], tcomp["q"]), (jcomp["scale"], tcomp["scale"]),
                      (jerr, terr), (jdeq, tdeq)):
        for w, t in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert str(t.dtype).split(".")[-1] == str(np.asarray(w).dtype)
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(np.asarray(w)))
    # no error state: zeros, as repro starts
    (jc0, _), (tc0, _) = jax.jit(jcompress)(jax.tree.map(jnp.asarray, g)), compress_gradients(
        tree_map(torch.from_numpy, g))
    for w, t in zip(jax.tree.leaves(jc0["q"]), tree_leaves(tc0["q"])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_compression_bounds_of_repro():
    """tests/test_optim.py:67-101 on the port: the round trip within half a
    scale, the exact residual, and error feedback unbiased over 50 steps."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))}
    comp, err = compress_gradients(g)
    deq = decompress_gradients(comp)
    scale = float(g["w"].abs().max()) / 127.0
    assert float((deq["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6
    # the residual is g - q * scale rounded once (XLA's fma): within half a
    # float32 ulp of the exact float64 value
    exact = (g["w"].double() - comp["q"]["w"].double() * comp["scale"]["w"].double()).numpy()
    np.testing.assert_allclose(err["w"].numpy(), exact, rtol=2**-24, atol=0)
    rng = np.random.default_rng(1)
    true_sum, deq_sum, err = np.zeros(32), np.zeros(32), None
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))}
        comp, err = compress_gradients(g, err)
        true_sum += g["w"].numpy()
        deq_sum += decompress_gradients(comp)["w"].numpy()
    assert np.abs(true_sum - deq_sum).max() < np.abs(true_sum).max() * 0.05 + 0.2


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("s,chunk,cap", [(16, 1024, None), (24, 8, 30.0), (12, 5, None)])
def test_cross_entropy_matches_repro(s, chunk, cap):
    """The whole-logits loss and the chunked one (chunk = the largest of
    `_pick_chunk`'s sizes that divides S) against repro's, rtol 1e-6: one
    float32 sum of the same terms in another order; chunked and whole agree
    as closely in the port."""
    from repro.models import common as jcm
    from repro_torch.models import common as tcm

    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, s)).astype(np.int32)
    jx, jt = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(table).astype(jnp.bfloat16)
    tx, tt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(table).to(torch.bfloat16)
    want = float(jax.jit(lambda a, b, c: jcm.cross_entropy_chunked(a, b, c, cap, chunk))(
        jx, jt, jnp.asarray(labels)))
    got = tcm.cross_entropy_chunked(tx, tt, torch.from_numpy(labels), cap, chunk)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    whole = jcm.cross_entropy_loss(jcm.unembed(jx, jt, cap), jnp.asarray(labels))
    tw = tcm.cross_entropy_loss(tcm.unembed(tx, tt, cap), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tw), float(whole), rtol=1e-6)
    np.testing.assert_allclose(float(tw), float(got), rtol=1e-6)
    assert tcm._pick_chunk(s, chunk) == jcm._pick_chunk(s, chunk)


# ------------------------------------------------------------------ adamw
def _bf16_tree(rng):
    return {"embed": rng.normal(size=(32, 16)).astype(np.float32),
            "layers": [{"wq": rng.normal(size=(16, 16)).astype(np.float32) * 0.3,
                        "ln1": np.zeros(16, np.float32)} for _ in range(2)]}


def _to_port(tree):
    return {"embed": torch.from_numpy(tree["embed"]).to(torch.bfloat16),
            "layers": [{"wq": torch.from_numpy(lp["wq"]).to(torch.bfloat16),
                        "ln1": torch.from_numpy(lp["ln1"])} for lp in tree["layers"]]}


def _to_repro(tree):
    return {"embed": jnp.asarray(tree["embed"]).astype(jnp.bfloat16),
            "layers": [{"wq": jnp.asarray(lp["wq"]).astype(jnp.bfloat16),
                        "ln1": jnp.asarray(lp["ln1"])} for lp in tree["layers"]]}


def test_adamw_on_bf16_params_matches_repro_and_updates_in_place():
    rng = np.random.default_rng(0)
    p0 = _to_port(_bf16_tree(rng))
    grads = [_to_port(_bf16_tree(rng)) for _ in range(3)]
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = JAdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jp = _to_repro(jax.tree.map(_np, p0))
    jopt = jadamw_init(jp)
    tp, topt = p0, adamw_init(p0)
    ip = tree_map(lambda t: t.clone(), p0)
    iopt = adamw_init(ip)
    jstep = jax.jit(lambda p, g, o: jadamw_update(p, g, o, jcfg))
    for g in grads:
        jp, jopt, jm = jstep(jp, _to_repro(jax.tree.map(_np, g)), jopt)
        tp, topt, tm = adamw_update(tp, g, topt, cfg)
        before = [t.data_ptr() for t in tree_leaves(ip)]
        ip, iopt, im = adamw_update_(ip, g, iopt, cfg)
        assert [t.data_ptr() for t in tree_leaves(ip)] == before
        # in place: the same bits as the functional update
        for a, b in zip(tree_leaves((ip, iopt["mu"], iopt["nu"])),
                        tree_leaves((tp, topt["mu"], topt["nu"]))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(iopt["step"]) == int(topt["step"]) == int(jopt["step"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for which in ("mu", "nu"):
            for a, b in zip(tree_leaves(topt[which]), jax.tree.leaves(jopt[which])):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32)
            np.testing.assert_allclose(_np(a), _np(b), rtol=2**-7, atol=1e-7)


# ------------------------------------------------------------ train step
def test_shapes_mirror_repro():
    assert tshapes.SHAPE_ORDER == jshapes.SHAPE_ORDER
    for name, s in jshapes.SHAPES.items():
        assert tshapes.SHAPES[name].__dict__ == s.__dict__
    assert list(tshapes.cells(list_archs())) == list(jshapes.cells(list_archs()))
    assert not tshapes.applicable(get_model("gemma-2b"), "long_500k")
    assert tshapes.applicable(get_model("zamba2-2.7b"), "long_500k")


@pytest.fixture(scope="module")
def gemma():
    jm = jget_model("gemma-2b", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model("gemma-2b", smoke=True)
    return jm, jp, tm


def _tp(tm, jp):
    return params_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_repro_build_train_step(gemma, microbatch):
    jm, jp, tm = gemma
    shape = jshapes.InputShape("t", "train", 32, 4)
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    raw = SyntheticTokenDataset(tm.vocab, 32, seed=1).batch(0, 4)
    mesh = make_host_mesh()
    with set_mesh_compat(mesh):
        jbuilt = jbuild_train_step(jm, mesh, shape, opt_cfg=JAdamWConfig(**cfg), donate=False,
                                   microbatch=microbatch)
        jbatch = jax.device_put({k: jnp.asarray(v) for k, v in raw.items()},
                                jbuilt.in_shardings[2])
        jp2, jopt, jmet = jbuilt.fn(jp, jadamw_init(jp), jbatch)
    tp = _tp(tm, jp)
    built = tsteps.build_step(tm, tshapes.InputShape("t", "train", 32, 4),
                              opt_cfg=AdamWConfig(**cfg), microbatch=microbatch)
    assert built.batch_shapes["labels"].shape == (4, 32)
    tp2, topt, tmet = built.fn(tp, adamw_init(tp), {k: torch.from_numpy(v)
                                                     for k, v in raw.items()})
    assert set(tmet) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-2)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    scale = (1 - 0.9) * min(1.0, 1.0 / float(jmet["grad_norm"]))
    want_mu = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jopt["mu"]))
    for w, g in zip(want_mu, jax.tree.leaves(params_to_arrays(tm, topt["mu"]))):
        step = 2.0 ** (np.floor(np.log2(np.abs(w).max() / scale)) - 7)
        np.testing.assert_allclose(g, w, rtol=0, atol=8 * step * scale)
    for w, g in zip(jax.tree.leaves(jp2), jax.tree.leaves(params_to_arrays(tm, tp2))):
        np.testing.assert_allclose(g, _np(w), rtol=2**-7, atol=2 * cfg["lr"])


def test_microbatch_accumulates_in_float32_and_donate_updates_in_place(gemma):
    """microbatch=2 is two half-batch gradients summed in float32 and halved;
    donate=False leaves the caller's tensors as they were."""
    jm, jp, tm = gemma
    shape = tshapes.InputShape("t", "train", 16, 4)
    raw = SyntheticTokenDataset(tm.vocab, 16, seed=2).batch(0, 4)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    tp = _tp(tm, jp)
    l0, g0 = tsteps.value_and_grad(tm, tp, {k: v[:2] for k, v in batch.items()})
    l1, g1 = tsteps.value_and_grad(tm, tp, {k: v[2:] for k, v in batch.items()})
    keep = tree_map(lambda t: t.clone(), tp)
    _, opt, met = tsteps.build_train_step(tm, shape, microbatch=2, donate=False).fn(
        tp, adamw_init(tp), batch)
    for a, b in zip(tree_leaves(tp), tree_leaves(keep)):
        assert torch.equal(a, b)
    assert float(met["loss"]) == float((l0 + l1) / 2)
    want = [(a.float() + b.float()) / 2 for a, b in zip(tree_leaves(g0), tree_leaves(g1))]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in want))
    assert float(met["grad_norm"]) == float(norm)
    ptrs = [t.data_ptr() for t in tree_leaves(tp)]
    out, _, _ = tsteps.build_train_step(tm, shape, microbatch=2).fn(tp, adamw_init(tp), batch)
    assert [t.data_ptr() for t in tree_leaves(out)] == ptrs
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(keep)))
    with pytest.raises(ValueError, match="microbatch"):
        tsteps.build_train_step(tm, shape, microbatch=3)


def test_loss_through_flash_raises_and_serving_flash_does_not(gemma):
    """The flash route has no backward: a loss that needs a gradient through
    it raises, here on the CPU as on the card; the serving prefill under
    no_grad still takes the route."""
    jm, jp, tm = gemma
    flash = tm.with_cfg(attn_impl="flash")
    batch = tm.example_inputs("train", 2, 16, "cpu")
    with pytest.raises(FlashBackwardError, match="no backward"):
        tsteps.value_and_grad(flash, tm.init_params(device="cpu"), batch)
    assert flash.prefill(tm.init_params(device="cpu"), batch).shape == (2, 1, tm.vocab)


# --------------------------------------------------------------- resume
def test_train_state_resume_equivalence(gemma, tmp_path):
    """tests/test_checkpoint.py:73 on the port: 4 steps equal 2 steps, a
    checkpoint (through the training CLI's state layout), a restore and 2
    more."""
    jm, jp, tm = gemma
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    ds = SyntheticTokenDataset(vocab=tm.vocab, seq_len=16, seed=1)
    step_fn = tsteps.build_train_step(tm, tshapes.InputShape("t", "train", 16, 4),
                                      opt_cfg=cfg).fn

    def run(params, opt, start, n):
        for s in range(start, n):
            batch = {k: torch.from_numpy(v) for k, v in ds.batch(s, 4).items()}
            params, opt, _ = step_fn(params, opt, batch)
        return params, opt

    params = _tp(tm, jp)
    pa, _ = run(tree_map(lambda t: t.clone(), params), adamw_init(params), 0, 4)
    pb, ob = run(tree_map(lambda t: t.clone(), params), adamw_init(params), 0, 2)
    ck = Checkpointer(tmp_path)
    ck.save_async(2, ttrain.state_arrays(pb, ob))
    like_p, like_o = tm.init_params(device="cpu"), adamw_init(tm.init_params(device="cpu"))
    arrays, _, step = ck.restore(ttrain.state_arrays(like_p, like_o))
    assert step == 2
    pr, orr = ttrain.state_from_arrays(arrays, like_p, like_o)
    assert int(orr["step"]) == 2 and orr["step"].dtype == torch.int32
    pc, _ = run(pr, orr, 2, 4)
    for a, c in zip(tree_leaves(pa), tree_leaves(pc)):
        assert a.dtype == c.dtype
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ CLI
def test_train_cli_refuses_what_repro_refuses():
    with pytest.raises(SystemExit, match="family=encdec"):
        ttrain.main(["--arch", "whisper-large-v3", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="family=vlm"):
        ttrain.main(["--arch", "internvl2-2b", "--smoke", "--device", "cpu"])
    for mesh, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit, match=f"needs a world of {ranks} ranks.*this one has 1"):
            ttrain.main(["--arch", "gemma-2b", "--smoke", "--mesh", mesh, "--device", "cpu"])


def test_train_cli_runs_checkpoints_and_resumes(tmp_path, capsys):
    """A 4-step smoke run writes steps 2 and 4; with step 4 removed, --resume
    starts from step 2 and ends on step 4's bits; --compress-grads changes
    nothing (parsed and not read, as in repro)."""
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "4", "--batch", "4", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    a = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert a["start_step"] == 0 and len(a["losses"]) == 4 and np.isfinite(a["losses"]).all()
    assert Checkpointer(tmp_path / "a").steps() == [2, 4]
    out = capsys.readouterr().out
    assert out.count("[train] step") == 4 and "done in" in out
    b = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "b"), "--compress-grads"])
    assert b["losses"] == a["losses"]
    import shutil

    shutil.rmtree(tmp_path / "b" / "step_0000000004")
    c = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert c["start_step"] == 2 and c["losses"] == a["losses"][2:]
    assert "resumed from step 2" in capsys.readouterr().out
    for d in ("a", "b"):
        with open(tmp_path / d / "step_0000000004" / "manifest.json") as f:
            assert json.load(f)["metadata"] == {"arch": "gemma-2b"}
    like = ttrain.state_arrays(*(lambda p: (p, adamw_init(p)))(
        get_model("gemma-2b", smoke=True).init_params(device="cpu")))
    ta, _, _ = Checkpointer(tmp_path / "a").restore(like)
    tb, _, _ = Checkpointer(tmp_path / "b").restore(like)
    assert set(ta) == set(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k])
