"""Every arch's training loss and gradient on the CPU, held against
`jax.jit(jax.value_and_grad(model.loss))` of `repro` (tests/test_arch_smoke.py's
call), from `repro`'s `init_params(PRNGKey(0))` crossed through `convert` and
one numpy batch (`ModelDef.example_inputs`, 2 x 32).

Bars, and why:
  * loss: rtol 1e-3. Both packages sum the same float32 cross entropy in
    other orders, and bf16 activations upstream round a few values the other
    way; the largest difference measured over the ten smoke models is
    1.1e-4 relative.
  * each gradient leaf: 8 bf16 steps at the leaf's largest |value| (a step
    at magnitude 2^e is 2^(e-7)): the gradients are bf16 for bf16
    parameters in both packages, and a flipped rounding of an activation
    or of a cotangent moves a sum over the batch by a few steps. Where a leaf
    misses that bar, its difference is held to the rounding noise of
    `repro`'s own bf16 gradient: at most 8 steps plus half the largest
    difference between `repro`'s bf16 gradient and its float32 one (the
    same parameters widened to float32, `common.DEFAULT_DTYPE` float32).
    zamba2-2.7b's shared block is such a case: its bf16 gradient lies up to
    43 steps from the float32 one in `repro` and 54 in the port, and the
    two packages 12 steps apart. In float32 every arch's gradient is
    `repro`'s within 6e-6 of each leaf's largest |value|.
  * the global norm: rtol 1e-2.
MoE routing flips are pinned as tests/test_torch_moe.py pins them: a flip
must be explained by the difference of the two router inputs, and the port
then runs with `repro`'s choice at that token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import ssm as jssm
from repro.models.registry import get_model as jget_model
from repro.models.registry import list_archs as jlist_archs
from repro_torch.convert import params_from_arrays, params_to_arrays
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import global_norm
from test_torch_moe import run_matched

torch.set_num_threads(1)

ARCHS = list(jlist_archs())
LOSS_RTOL = 1e-3
NORM_RTOL = 1e-2
LEAF_STEPS = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _step(a):
    top = float(np.abs(a).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def repro_loss_and_grads(jm, jp, batch, dtype=jnp.bfloat16):
    """`jax.jit(jax.value_and_grad(jm.loss))` on numpy `batch`; in float32
    with the parameters and the default dtype widened when asked."""
    if dtype == jnp.float32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jb = {k: jnp.asarray(v).astype(dtype) if v.dtype.kind == "f" else jnp.asarray(v)
          for k, v in batch.items()}
    keep = jcm.DEFAULT_DTYPE
    jcm.DEFAULT_DTYPE = dtype
    try:
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    finally:
        jcm.DEFAULT_DTYPE = keep
    return float(loss), jax.tree.map(lambda a: np.asarray(a, np.float32), grads)


def check_gradients(arch, jm, jp, batch, want, got, want_loss, got_loss):
    """The bars of the module docstring; `want` and `got` in repro's layout."""
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss), (arch, got_loss, want_loss)
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(want)]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    f32 = None
    for path, w, g in zip(paths, jax.tree.leaves(want), jax.tree.leaves(got)):
        step, diff = _step(w), float(np.abs(g - w).max())
        if diff <= LEAF_STEPS * step:
            continue
        if f32 is None:
            f32 = dict(zip(paths, jax.tree.leaves(
                repro_loss_and_grads(jm, jp, batch, jnp.float32)[1])))
        noise = float(np.abs(w - f32[path]).max())
        assert diff <= LEAF_STEPS * step + noise / 2, (
            f"{arch} {path}: {diff / step:.1f} bf16 steps from repro, whose own bf16 "
            f"gradient is {noise / step:.1f} steps from its float32 one")
        print(f"{arch} {path}: {diff / step:.1f} steps from repro, within half of repro's "
              f"{noise / step:.1f}-step bf16 noise + {LEAF_STEPS}")
    norm = lambda t: float(np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))  # noqa: E731
                                       for a in jax.tree.leaves(t))))
    assert abs(norm(got) - norm(want)) <= NORM_RTOL * norm(want), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_repro(arch, monkeypatch):
    jm = jget_model(arch, smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_model(arch, smoke=True)
    tp = params_from_arrays(tm, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    tb = tm.example_inputs("train", 2, 32, "cpu", seed=1)
    batch = {k: _np(v) if v.is_floating_point() else v.numpy() for k, v in tb.items()}

    def run_repro():
        return repro_loss_and_grads(jm, jp, batch)

    def run_port():
        loss, grads = value_and_grad(tm, tp, tb)
        return float(loss), grads

    if getattr(tm.cfg, "moe", None) is not None:
        (want_loss, want), (got_loss, grads), _ = run_matched(monkeypatch, jm.cfg, run_repro,
                                                              run_port)
    else:
        (want_loss, want), (got_loss, grads) = run_repro(), run_port()
    got = params_to_arrays(tm, grads)
    check_gradients(arch, jm, jp, batch, want, got, want_loss, got_loss)
    # the port's own norm is the one its optimizer clips by
    np.testing.assert_allclose(float(global_norm(grads)),
                               np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                                           for a in jax.tree.leaves(got))), rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b", "mamba2-130m", "zamba2-2.7b",
                                  "whisper-large-v3", "internvl2-2b"])
def test_remat_policies_give_the_same_gradients(arch):
    """"none", "dots" and "full" move memory, not values: the loss and every
    gradient leaf bit for bit, for each family."""
    tm = get_model(arch, smoke=True)
    params = tm.init_params(device="cpu")
    batch = tm.example_inputs("train", 2, 32, "cpu", seed=2)
    runs = {}
    for policy in ("none", "dots", "full"):
        loss, grads = value_and_grad(tm.with_cfg(remat=policy), params, batch)
        runs[policy] = (loss, jax.tree.leaves(params_to_arrays(tm, grads)))
    for policy in ("dots", "full"):
        assert torch.equal(runs[policy][0], runs["none"][0]), policy
        for a, b in zip(runs[policy][1], runs["none"][1]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(tm.with_cfg(remat="some"), params, batch)


def test_ssd_gradient_is_finite_at_a_full_chunk():
    """At a full chunk of 128 tokens the causal decay exp(cum_i - cum_j) of
    SSD overflows above the diagonal (a positive sum of dt), where repro
    masks it after the exp: its gradient there is 0 * inf = NaN (repro's
    `jax.grad` of `ssd_chunked` on these inputs gives NaN for dt). The port
    masks before the exp; its float32 gradient is finite and within 1e-4 of
    each leaf's largest |value| of the float64 one, and its output is
    repro's within 1e-5 of the largest |value|."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 8, 4
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) + 1.0))  # softplus, ~1.3 a token
    a = -np.ones(h)
    bc = [rng.standard_normal((b, s, 1, n)) for _ in range(2)]

    def grads(dtype):
        ts = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in (x, dt)]
        y, state = tssm.ssd_chunked(*ts, torch.tensor(a, dtype=dtype),
                                   *(torch.tensor(v, dtype=dtype) for v in bc), 128)
        (y.sum() + state.sum()).backward()
        return y, [t.grad for t in ts]

    y32, g32 = grads(torch.float32)
    _, g64 = grads(torch.float64)
    for g, w in zip(g32, g64):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4 * float(w.abs().max()))
    # the forward is repro's (float32 sums in other orders)
    want, _ = jax.jit(lambda *v: jssm.ssd_chunked(*v, 128))(
        *(jnp.asarray(v, jnp.float32) for v in (x, dt, a, *bc)))
    assert np.abs(np.asarray(want) - y32.detach().numpy()).max() <= 1e-5 * np.abs(want).max()
