"""The port's logical-axis layout (`models.sharding`, `launch.mesh`, the
meshed steps' layouts) held against `repro`'s.

  * the rules and PartitionSpecs of every logical axis on ("data",
    "model") and ("pod", "data", "model");
  * `param_logical` and `param_shapes` of all 10 archs, full and smoke,
    leaf for leaf against `repro`'s (the port keeps a list of layers where
    `repro` stacks them: a stacked leaf's leading "layers" axis, and the
    hybrid's (layers, None) pair, are dropped to compare);
  * the spec of every parameter, ZeRO-1 moment, batch, cache and logits
    leaf of every arch x applicable shape x {(2, 4), 16x16, 2x16x16}, equal
    to `repro`'s `safe_sharding(...).spec`. `repro`'s side runs in one
    subprocess with 512 forced host devices, as its dry run does, through
    its own `build_step` (its model trace for the logits' shape replaced by
    the shape [B, 1, V], which is all the layout reads); the port's side
    runs on a fake world of the mesh's size;
  * every rank's block of a tensor on (2, 4), DTensor's offsets against
    JAX's `devices_indices_map`, a dim split over ("data", "model") among
    them (major to minor, as JAX lays out a tuple of axes).
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.shapes import SHAPE_ORDER, SHAPES, applicable
from repro_torch.models import sharding as sh
from repro_torch.models.registry import get_model, list_archs

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list(list_archs())


def _leaves(tree):
    """(path, leaf) in sorted-key order; a logical tuple or a spec is a leaf."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree) for p, x in _leaves(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not sh.is_logical_leaf(tree)
                                  and not _is_spec(tree)):
        return [(f"{i}/{p}", x) for i, t in enumerate(tree) for p, x in _leaves(t)]
    return [("", tree)]


def _is_spec(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def _unstack(model, tree, drop):
    """`repro`'s tree (stacked layers) as the port's (lists of layers): a
    stacked leaf becomes one leaf a layer, `drop(leaf, n)` taking off its n
    leading stack axes."""
    cfg = model.cfg
    fam = model.family

    def layers(stack, n, k=1):
        return [_map(stack, lambda a: drop(a, k)) for _ in range(n)]

    if fam == "vlm":
        lm = type(model)(model.name, "decoder", cfg.lm)
        return {"projector": tree["projector"], "lm": _unstack(lm, tree["lm"], drop)}
    out = {k: v for k, v in tree.items()
           if k not in ("layers", "prefix", "enc_layers", "dec_layers")}
    if fam == "decoder":
        npos, n_prefix = len(cfg.attn_pattern), cfg.n_dense_prefix
        out["layers"] = []
        for i in range(cfg.n_layers):
            stack = tree["prefix"] if i < n_prefix else tree["layers"][(i - n_prefix) % npos]
            out["layers"].append(_map(stack, lambda a: drop(a, 1)))
    elif fam == "ssm":
        out["layers"] = layers(tree["layers"], cfg.n_layers)
    elif fam == "hybrid":
        out["layers"] = [layers(tree["layers"], cfg.shared_every, 2) for _ in range(cfg.n_super)]
    elif fam == "encdec":
        out["enc_layers"] = layers(tree["enc_layers"], cfg.n_enc_layers)
        out["dec_layers"] = layers(tree["dec_layers"], cfg.n_dec_layers)
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------------ rules
def test_rules_and_pspecs_match_repro():
    from repro.models import sharding as jsh

    for axes in (("data", "model"), ("pod", "data", "model")):
        mesh = types.SimpleNamespace(axis_names=axes)
        rules = sh.rules_for_mesh(mesh)
        assert rules == jsh.rules_for_mesh(mesh), axes
        for over in ({"embed": ("pod", "data")}, {"seq": ("model",)}):
            assert sh.rules_for_mesh(mesh, over) == jsh.rules_for_mesh(mesh, over)
        for name in jsh.BASE_RULES:
            for logical in ((name,), (name, None), ("batch", name)):
                assert sh.pspec(logical, rules) == tuple(jsh.pspec(logical, rules)), logical
        assert sh.dp_axes(mesh) == jsh.dp_axes(mesh)
    assert sh.BASE_RULES == jsh.BASE_RULES


HOST_MESH = r"""
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

assert not dist.is_initialized()
mesh = make_host_mesh(device_type="cpu")
assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
for multi, need in ((False, 256), (True, 512)):
    try:
        make_production_mesh(multi_pod=multi, device_type="cpu")
        raise SystemExit("no refusal")
    except ValueError as e:
        assert f"needs {need} ranks; the world has 1" in str(e), e
print("OK")
"""


def test_host_mesh_forms_a_world_of_one(tmp_path):
    """With no process group up, `make_host_mesh` is a (1, 1) mesh over a
    world of 1 it forms; the production meshes name the ranks they need.
    In a fresh interpreter: the world it forms stays up."""
    env = dict(os.environ, PYTHONPATH=SRC, TMPDIR=str(tmp_path))
    run = subprocess.run([sys.executable, "-c", HOST_MESH], env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip().endswith("OK"), run.stderr[-2000:]


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sh.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="used twice"):
        sh.placements(("model", "model"), mesh)


# ----------------------------------------------------- logical axes, shapes
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_and_shapes_match_repro(arch, smoke):
    import jax
    import jax.numpy as jnp

    from repro.models.registry import get_model as jget_model

    jm, tm = jget_model(arch, smoke=smoke), get_model(arch, smoke=smoke)

    def drop_logical(t, k):
        lead = ("layers", None)[:k]
        assert t[:k] == lead, t
        return t[k:]

    want_logical = _unstack(tm, jm.param_logical(), drop_logical)
    got_logical = tm.param_logical()
    want_shapes = _unstack(tm, jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                           lambda s, k: jax.ShapeDtypeStruct(s.shape[k:], s.dtype))
    got_shapes = tm.param_shapes()
    w, g = _leaves(want_logical), _leaves(got_logical)
    assert [p for p, _ in w] == [p for p, _ in g]
    assert [x for _, x in w] == [x for _, x in g]
    ws, gs = _leaves(want_shapes), _leaves(got_shapes)
    assert [p for p, _ in ws] == [p for p, _ in w]
    dtypes = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    for (path, a), (_, b) in zip(ws, gs):
        assert tuple(a.shape) == tuple(b.shape) and dtypes[jnp.dtype(a.dtype)] == b.dtype, path
        assert b.device.type == "meta", path


# ------------------------------------------------------------ step layouts
REPRO_SPECS = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.steps as steps
from repro.launch.shapes import SHAPES, SHAPE_ORDER, applicable
from repro.models.registry import get_model, list_archs

real_eval_shape = jax.eval_shape
vocab = [0]


def eval_shape(fn, *args):
    if getattr(fn, "__name__", "") == "prefill":
        return jax.ShapeDtypeStruct((args[1]["tokens"].shape[0], 1, vocab[0]), np.float32)
    if getattr(fn, "__name__", "") == "decode":
        return (jax.ShapeDtypeStruct((args[2]["tokens"].shape[0], 1, vocab[0]), np.float32),
                args[1])
    return real_eval_shape(fn, *args)


steps.jax.eval_shape = eval_shape
meshes = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
devs = np.array(jax.devices())
spec = lambda tree: jax.tree.map(lambda s: tuple(s.spec) + (None,) * 0, tree,
                                 is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
out = {}
for arch in list_archs():
    m = get_model(arch)
    vocab[0] = m.cfg.lm.vocab if m.family == "vlm" else m.cfg.vocab
    for name in SHAPE_ORDER:
        if not applicable(m, name):
            continue
        for mesh_name, (shape, axes) in meshes.items():
            n = int(np.prod(shape))
            mesh = Mesh(devs[:n].reshape(shape), axes)
            built = steps.build_step(m, mesh, SHAPES[name])
            out[(arch, name, mesh_name)] = (spec(built.in_shardings), spec(built.out_shardings))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def repro_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "specs.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", REPRO_SPECS, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _fake_world(n, rank=0):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)


@pytest.fixture
def fake_world():
    yield _fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_tree(tree):
    """A tree of the port's `Sharding`s as their specs."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_tree(v) for v in tree)
    return tree.spec


def _port_cache(model, tree):
    """`repro`'s cache specs under the port's cache keys (every stack of a
    key has one spec: its stack axes are unsharded)."""
    if model.family in ("decoder", "vlm"):
        stacks = list(tree["layers"]) + ([tree["prefix"]] if "prefix" in tree else [])
        assert all(s == stacks[0] for s in stacks)
        k, v = stacks[0]
        if isinstance(k, dict):  # the int8 cache
            return {"k_q": k["q"], "k_s": k["s"], "v_q": v["q"], "v_s": v["s"]}
        return {"k": k, "v": v}
    if model.family == "hybrid":
        return {"ssm": tree["ssm"], "conv": tree["conv"], "k": tree["attn"][0],
                "v": tree["attn"][1]}
    if model.family == "encdec":
        return {"self_k": tree["self"][0], "self_v": tree["self"][1],
                "cross_k": tree["cross"][0], "cross_v": tree["cross"][1]}
    return tree


def _drop_spec(s, k):
    assert s[:k] == (None,) * k, s
    return s[k:]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_every_step_layout_matches_repro(repro_specs, fake_world, mesh_name):
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.launch.steps import build_step

    shape, axes = MESHES[mesh_name]
    fake_world(int(np.prod(shape)))
    mesh = make_compat_mesh(shape, axes, "cpu")
    n_cells = 0
    for arch in ARCHS:
        model = get_model(arch)
        for name in SHAPE_ORDER:
            if not applicable(model, name):
                continue
            jin, jout = repro_specs[(arch, name, mesh_name)]
            built = build_step(model, SHAPES[name], mesh)
            got_in, got_out = _spec_tree(built.in_shardings), _spec_tree(built.out_shardings)
            what = f"{arch} {name} {mesh_name}"
            want_params = _unstack(model, jin[0], _drop_spec)
            assert _leaves(got_in[0]) == _leaves(want_params), what + " params"
            if SHAPES[name].mode == "train":
                for moment in ("mu", "nu"):
                    assert _leaves(got_in[1][moment]) == _leaves(
                        _unstack(model, jin[1][moment], _drop_spec)), what + " " + moment
                assert got_in[1]["step"] == jin[1]["step"] == ()
                assert got_in[2] == jin[2], what + " batch"
                assert got_out[2] == jout[2], what + " metrics"
            elif SHAPES[name].mode == "prefill":
                assert got_in[1] == jin[1], what + " batch"
                assert got_out == jout, what + " logits"
            else:
                assert got_in[1] == _port_cache(model, jin[1]), what + " cache"
                assert got_in[2] == jin[2], what + " batch"
                assert got_out[0] == jout[0], what + " logits"
            n_cells += 1
    assert n_cells == 32


def test_rank_blocks_match_jax_on_2x4(fake_world):
    """DTensor's block of each rank (`compute_local_shape_and_global_offset`
    on rank r of a fake world of 8) is JAX's `devices_indices_map` block of
    device r of a (2, 4) mesh, for specs that split one dim over one axis,
    two dims over both, and one dim over both axes (major to minor)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import make_compat_mesh

    shape = (8, 16, 12)
    specs = [("data", None, None), (None, "model", None), ("data", "model", None),
             (("data", "model"), None, None), (None, ("data", "model"), None)]
    code = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
specs = pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
flat = list(mesh.devices.flat)
out = []
for s in specs:
    m = NamedSharding(mesh, P(*s)).devices_indices_map((8, 16, 12))
    out.append([tuple((sl.start or 0, sl.stop if sl.stop is not None else n)
                      for sl, n in zip(m[d], (8, 16, 12))) for d in flat])
print(pickle.dumps(out).hex())
"""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", code, pickle.dumps(specs).hex()], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    want = pickle.loads(bytes.fromhex(run.stdout.strip().splitlines()[-1]))
    for rank in range(8):
        fake_world(8, rank)
        mesh = make_compat_mesh((2, 4), ("data", "model"), "cpu")
        for s, blocks in zip(specs, want):
            size, offset = compute_local_shape_and_global_offset(shape, mesh,
                                                                  sh.placements(s, mesh))
            got = tuple((o, o + n) for o, n in zip(offset, size))
            assert got == blocks[rank], (rank, s, got, blocks[rank])
