"""Carry the JAX package's state into the port, as numpy arrays.

The port imports nothing of `repro`; what crosses is plain data:

  * `country_data_from_arrays` builds the port's `CountryData` from a
    dataset's arrays, for any model (a registered name or a spec, regional
    ones with their [R * n_obs, T] region-major rows and, if given, their
    labels checked), so both packages can fit one series (`repro`'s series
    come from threefry, the port's own from the counter hash);
  * `schedule_from_fields` builds the port's `InterventionSchedule` from the
    plain tuples of `repro`'s (tv_params, breakpoints, scale_lows,
    scale_highs);
  * `load_npz` reads an `ABCState` checkpoint or a `Posterior` file written
    by `repro` (or by the port; the `.npz` fields are the same) into the
    port's type, so a fit started in `repro` resumes in the port;
  * `theta_to_soa` lays a [B, P] parameter batch out as the kernel's
    structure of arrays [P, B];
  * `decoder_params_from_arrays` turns `repro`'s decoder parameter tree
    (numpy arrays) into the port's parameters, and `params_from_arrays`
    does the same for every family (decoder, ssm, hybrid, encdec, vlm);
    `cache_from_arrays` carries a decode cache across likewise, so that
    both packages can decode on from one state; `params_to_arrays` goes
    the other way, for any tree shaped like the port's parameters (a
    gradient, an optimizer moment): the port's per-layer lists restacked
    into `repro`'s layout as float32 numpy arrays;
  * `mdn_params_from_arrays` does the same for the NPE estimator's MDN,
    from its leaves in `jax.tree.leaves` order (the order of an estimator
    file's `leaf_%03d` arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Union

import numpy as np
import torch

from repro_torch.core.abc import ABCState
from repro_torch.core.npe import NPEConfig, mdn_template
from repro_torch.core.posterior import Posterior
from repro_torch.epi.data import CountryData
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule
from repro_torch.kernels.abc_sim import theta_to_soa
from repro_torch.models import common as cm
from repro_torch.models.decoder import DecoderConfig, check_supported
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

__all__ = ["cache_from_arrays", "country_data_from_arrays", "decoder_params_from_arrays",
           "load_npz", "mdn_params_from_arrays", "params_from_arrays", "params_to_arrays",
           "schedule_from_fields", "theta_to_soa"]


def country_data_from_arrays(
    name: str,
    population: float,
    a0: float,
    r0: float,
    d0: float,
    observed,
    *,
    true_theta: Sequence[float] | None = None,
    paper_tolerance: float | None = None,
    model="siard",
    synthetic: bool = True,
    observed_channels: Sequence[str] | None = None,
) -> CountryData:
    """A port `CountryData` from a dataset's scalars and [total_observed, T]
    series; `observed_channels` (e.g. `repro`'s labels) must be the
    model's."""
    spec = get_model(model)
    obs = np.array(observed, np.float32, copy=True)
    if obs.ndim != 2 or obs.shape[0] != spec.total_observed:
        raise ValueError(
            f"observed must be [{spec.total_observed}, T] for {spec.name}, got {obs.shape}"
        )
    if observed_channels is not None and tuple(observed_channels) != spec.observed_labels:
        raise ValueError(
            f"observed channels {tuple(observed_channels)} are not {spec.name}'s "
            f"{spec.observed_labels}"
        )
    return CountryData(
        name=name,
        population=float(population),
        a0=float(a0),
        r0=float(r0),
        d0=float(d0),
        observed=obs,
        paper_tolerance=paper_tolerance,
        true_theta=None if true_theta is None else tuple(float(x) for x in true_theta),
        synthetic=synthetic,
        model=spec.name,
        observed_channels=spec.observed_labels,
    )


def schedule_from_fields(tv_params, breakpoints, scale_lows,
                         scale_highs) -> InterventionSchedule:
    """The port's `InterventionSchedule` from a schedule's plain fields (as
    `repro`'s carries them: names, days and per-window bound rows)."""
    return InterventionSchedule(
        tv_params=tuple(str(p) for p in tv_params),
        breakpoints=tuple(int(b) for b in breakpoints),
        scale_lows=tuple(tuple(float(x) for x in row) for row in scale_lows),
        scale_highs=tuple(tuple(float(x) for x in row) for row in scale_highs),
    )


def load_npz(path: str) -> Union[ABCState, Posterior]:
    """The `ABCState` or `Posterior` in `path`, told apart by its fields."""
    with np.load(path, allow_pickle=False) as z:
        fields = set(z.files)
    if set(ABCState._REQUIRED_KEYS) <= fields:
        return ABCState.load(path)
    if set(Posterior._REQUIRED_KEYS) <= fields:
        return Posterior.load(path)
    raise ValueError(
        f"{path!r} holds neither an ABCState checkpoint nor a Posterior "
        f"(fields {sorted(fields)})"
    )


#: parameters kept in float32 (norm scales, the MoE router, a Mamba layer's
#: norms, conv bias, dt bias, A_log and D, and the encoder-decoder's layer
#: norms and MLP biases); every other leaf is bf16
_F32_LEAVES = ("ln1", "ln2", "post_attn", "post_ffn", "final_norm", "router",
               "ln", "conv_b", "dt_bias", "A_log", "D", "gate_norm", "scale", "bias",
               "b1", "b2")


def _leaf(name: str, a, device) -> torch.Tensor:
    dtype = torch.float32 if name in _F32_LEAVES else cm.DEFAULT_DTYPE
    return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)


def _layer_from_stack(stack: Dict[str, Any], j: int, device) -> Dict[str, Any]:
    """Layer j of a stacked parameter dict, nested dicts (the MoE's) included."""
    return {name: _layer_from_stack(a, j, device) if isinstance(a, dict) else
            _leaf(name, a[j], device) for name, a in stack.items()}


def decoder_params_from_arrays(cfg: DecoderConfig, tree: Dict[str, Any],
                               device="cpu") -> Dict[str, Any]:
    """The port's decoder parameters from `repro`'s parameter tree of numpy
    arrays (float32, or bf16 values in any float type: bf16 -> float32 ->
    bf16 is exact).

    `repro` stacks its dense prefix layers in `tree["prefix"]` ([n_dense_prefix,
    ...]), which become the first layers, and the others per
    attention-pattern position: layer n_dense_prefix + g * len(attn_pattern)
    + p is `tree["layers"][p][g]`, its MoE parameters under `"moe"`. Its
    embedding is [V, d] and serves as the unembedding when `tie_embed`.
    """
    check_supported(cfg)
    npos = len(cfg.attn_pattern)
    if len(tree["layers"]) != npos:
        raise ValueError(f"expected {npos} pattern positions, got {len(tree['layers'])}")
    n_prefix = cfg.n_dense_prefix
    if bool(n_prefix) != ("prefix" in tree):
        raise ValueError(f"{cfg.name}: n_dense_prefix={n_prefix} but the tree "
                         f"{'has' if 'prefix' in tree else 'lacks'} a prefix stack")
    layers = []
    for i in range(cfg.n_layers):
        if i < n_prefix:
            layers.append(_layer_from_stack(tree["prefix"], i, device))
        else:
            j = i - n_prefix
            layers.append(_layer_from_stack(tree["layers"][j % npos], j // npos, device))
    params = {"embed": _leaf("embed", tree["embed"], device),
              "final_norm": _leaf("final_norm", tree["final_norm"], device),
              "layers": layers}
    if not cfg.tie_embed:
        params["unembed"] = _leaf("unembed", tree["unembed"], device)
    return params


def _mamba_layers(stack: Dict[str, Any], n: int, device) -> list:
    return [_layer_from_stack(stack, j, device) for j in range(n)]


def params_from_arrays(model, tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The port's parameters of `model` (a `ModelDef`) from `repro`'s tree
    of numpy arrays, by family:

      * decoder: `decoder_params_from_arrays`;
      * ssm: the layers stacked [L, ...] become a list of L layer dicts;
      * hybrid: the Mamba layers stacked [n_super, shared_every, ...] become
        n_super lists of shared_every dicts, beside the shared block's
        parameters under "shared";
      * vlm: the projector's two matrices, and the decoder tree under "lm";
      * encdec: the stacked "enc_layers" and "dec_layers" become lists of
        layer dicts (their norms and attention nested as in `repro`).
    """
    cfg = model.cfg
    if model.family == "decoder":
        return decoder_params_from_arrays(cfg, tree, device)
    if model.family == "vlm":
        return {"projector": {k: _leaf(k, tree["projector"][k], device) for k in ("w1", "w2")},
                "lm": decoder_params_from_arrays(cfg.lm, tree["lm"], device)}
    if model.family == "encdec":
        ln = lambda t: {k: _leaf(k, a, device) for k, a in t.items()}  # noqa: E731
        return {"frontend": _leaf("frontend", tree["frontend"], device),
                "enc_layers": _mamba_layers(tree["enc_layers"], cfg.n_enc_layers, device),
                "enc_norm": ln(tree["enc_norm"]),
                "embed": _leaf("embed", tree["embed"], device),
                "dec_pos": _leaf("dec_pos", tree["dec_pos"], device),
                "dec_layers": _mamba_layers(tree["dec_layers"], cfg.n_dec_layers, device),
                "dec_norm": ln(tree["dec_norm"])}
    out = {"embed": _leaf("embed", tree["embed"], device),
           "final_norm": _leaf("final_norm", tree["final_norm"], device)}
    if model.family == "ssm":
        out["layers"] = _mamba_layers(tree["layers"], cfg.n_layers, device)
        return out
    if model.family == "hybrid":
        stack = tree["layers"]
        out["layers"] = [_mamba_layers({k: a[i] for k, a in stack.items()}, cfg.shared_every,
                                       device) for i in range(cfg.n_super)]
        out["shared"] = {k: _leaf(k, a, device) for k, a in tree["shared"].items()}
        return out
    raise NotImplementedError(f"{model.name}: no parameter conversion for the "
                              f"{model.family!r} family")


def _decoder_cache(cfg: DecoderConfig, tree: Dict[str, Any], spec, device):
    """`repro`'s decoder cache {"layers": ((k, v) a pattern position),
    "prefix": (k, v)} (entries bf16, or {"q", "s"} int8 and scales) as the
    port's one row of layers: layer i of the port is the prefix's i, then
    pattern stack (i - prefix) % len(pattern), group (i - prefix) //
    len(pattern), as in `decoder_params_from_arrays`."""
    npos, n_prefix = len(cfg.attn_pattern), cfg.n_dense_prefix
    out = {name: torch.empty(s.shape, dtype=s.dtype, device=device) for name, s in spec.items()}
    for i in range(cfg.n_layers):
        if i < n_prefix:
            kv, g = tree["prefix"], i
        else:
            kv, g = tree["layers"][(i - n_prefix) % npos], (i - n_prefix) // npos
        for which, entry in zip("kv", kv):
            parts = ({which: entry} if not isinstance(entry, dict) else
                     {f"{which}_q": entry["q"], f"{which}_s": entry["s"]})
            for name, a in parts.items():
                out[name][i] = torch.from_numpy(np.array(a[g], np.float32)).to(out[name].dtype)
    return out


def cache_from_arrays(model, tree: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """The port's decode cache of `model` from `repro`'s cache tree of numpy
    arrays (bf16 values may come as float32: the crossing is exact). The ssm
    cache keeps its keys and shapes; the hybrid's {"attn": (k, v)} becomes
    {"k", "v"}; a decoder's (and a vlm's) per-pattern stacks become one row
    of layers."""
    b, t = _cache_batch_len(model, tree)
    spec = model.init_cache_shape(b, t)
    if model.family in ("decoder", "vlm"):
        cfg = model.cfg.lm if model.family == "vlm" else model.cfg
        return _decoder_cache(cfg, tree, spec, device)
    flat = dict(tree)
    if model.family == "hybrid":
        flat["k"], flat["v"] = flat.pop("attn")
    if model.family == "encdec":
        flat["self_k"], flat["self_v"] = flat.pop("self")
        flat["cross_k"], flat["cross_v"] = flat.pop("cross")
    if set(flat) != set(spec):
        raise ValueError(f"cache keys {sorted(flat)} != the port's {sorted(spec)}")
    out = {}
    for name, s in spec.items():
        a = np.array(flat[name], np.float32)
        if a.shape != tuple(s.shape):
            raise ValueError(f"cache {name}: shape {a.shape} != {tuple(s.shape)}")
        out[name] = torch.from_numpy(a).to(device=device, dtype=s.dtype)
    return out


def _cache_batch_len(model, tree):
    """(batch, cache length) of a `repro` cache tree (length 0 for ssm)."""
    if model.family == "ssm":
        return np.shape(tree["ssm"])[1], 0
    if model.family in ("hybrid", "encdec"):
        shape = np.shape(tree["attn" if model.family == "hybrid" else "self"][0])
        return shape[1], shape[2]
    entry = tree["layers"][0][0]
    shape = np.shape(entry["q"] if isinstance(entry, dict) else entry)
    return shape[1], shape[2]


def _host(t) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _stack(layers) -> Dict[str, Any]:
    """A list of layer dicts (nested dicts included) stacked on a new first
    axis, as float32 numpy arrays."""
    return {name: _stack([lp[name] for lp in layers]) if isinstance(layers[0][name], dict)
            else np.stack([_host(lp[name]) for lp in layers]) for name in layers[0]}


def _flat(tree) -> Any:
    return ({k: _flat(v) for k, v in tree.items()} if isinstance(tree, dict)
            else _host(tree))


def params_to_arrays(model, tree: Dict[str, Any]) -> Dict[str, Any]:
    """A tree shaped like the port's parameters of `model` (the parameters,
    a gradient, a moment) in `repro`'s layout, float32 numpy arrays: the
    inverse of `params_from_arrays` but for dtypes (every leaf float32)."""
    cfg = model.cfg
    if model.family == "vlm":
        return {"projector": _flat(tree["projector"]),
                "lm": params_to_arrays(dataclasses.replace(model, family="decoder",
                                                           cfg=cfg.lm), tree["lm"])}
    out = {k: _flat(v) for k, v in tree.items()
           if k not in ("layers", "enc_layers", "dec_layers")}
    if model.family == "decoder":
        npos, n_prefix = len(cfg.attn_pattern), cfg.n_dense_prefix
        layers = tree["layers"]
        if n_prefix:
            out["prefix"] = _stack(layers[:n_prefix])
        out["layers"] = tuple(_stack(layers[n_prefix + p::npos]) for p in range(npos))
    elif model.family == "ssm":
        out["layers"] = _stack(tree["layers"])
    elif model.family == "hybrid":
        sites = [_stack(site) for site in tree["layers"]]
        out["layers"] = {k: np.stack([s_[k] for s_ in sites]) for k in sites[0]}
    elif model.family == "encdec":
        out["enc_layers"] = _stack(tree["enc_layers"])
        out["dec_layers"] = _stack(tree["dec_layers"])
    else:
        raise NotImplementedError(f"{model.name}: no {model.family!r} family")
    return out


def mdn_params_from_arrays(leaves: Sequence, cfg: NPEConfig, n_features: int,
                           n_params: int, device="cpu") -> Dict[str, Any]:
    """The port's MDN parameters (float32 on `device`) from `repro`'s leaves
    in `jax.tree.leaves` order: blocks[i].{b1, b2, ln_b, ln_s, w1, w2} for
    each block, then head_b, head_w, in_b, in_w."""
    template = mdn_template(n_features, n_params, cfg)
    want = tree_leaves(template)
    leaves = [np.asarray(a, np.float32) for a in leaves]
    if len(leaves) != len(want):
        raise ValueError(f"expected {len(want)} leaves, got {len(leaves)}")
    for got, w in zip(leaves, want):
        if got.shape != tuple(w.shape):
            raise ValueError(f"leaf shape {got.shape} != expected {tuple(w.shape)}")
    return tree_unflatten(template, [torch.from_numpy(a.copy()).to(device) for a in leaves])
