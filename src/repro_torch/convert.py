"""Carry the JAX package's state into the port, as numpy arrays.

The port imports nothing of `repro`; what crosses is plain data:

  * `country_data_from_arrays` builds the port's `CountryData` from a
    dataset's arrays, so both packages can fit one series (`repro`'s series
    come from threefry, the port's own from the counter hash);
  * `load_npz` reads an `ABCState` checkpoint or a `Posterior` file written
    by `repro` (or by the port; the `.npz` fields are the same) into the
    port's type, so a fit started in `repro` resumes in the port;
  * `theta_to_soa` lays a [B, P] parameter batch out as the kernel's
    structure of arrays [P, B].
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from repro_torch.core.abc import ABCState
from repro_torch.core.posterior import Posterior
from repro_torch.epi.data import CountryData
from repro_torch.epi.models import get_model
from repro_torch.kernels.abc_sim import theta_to_soa

__all__ = ["country_data_from_arrays", "load_npz", "theta_to_soa"]


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
    model: str = "siard",
    synthetic: bool = True,
) -> CountryData:
    """A port `CountryData` from a dataset's scalars and [n_obs, T] series."""
    spec = get_model(model)
    obs = np.array(observed, np.float32, copy=True)
    if obs.ndim != 2 or obs.shape[0] != spec.n_observed:
        raise ValueError(
            f"observed must be [{spec.n_observed}, T] for {spec.name}, got {obs.shape}"
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
