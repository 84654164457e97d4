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
    (numpy arrays) into the port's parameters;
  * `mdn_params_from_arrays` does the same for the NPE estimator's MDN,
    from its leaves in `jax.tree.leaves` order (the order of an estimator
    file's `leaf_%03d` arrays).
"""

from __future__ import annotations

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

__all__ = ["country_data_from_arrays", "decoder_params_from_arrays", "load_npz",
           "mdn_params_from_arrays", "schedule_from_fields", "theta_to_soa"]


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


#: parameters kept in float32 (norm scales and the MoE router); every other
#: leaf is bf16
_F32_LEAVES = ("ln1", "ln2", "post_attn", "post_ffn", "final_norm", "router")


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
