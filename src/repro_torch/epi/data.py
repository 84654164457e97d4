"""Datasets for the port: country demo series and a small synthetic problem.

The same generating parameters and metadata as `repro.epi.data`: the paper's
Table 8 posterior means for italy, new_zealand and usa with their
(population, A0, R0, D0) starting points, and `synthetic_small` at a
population of one million.

These series are NOT bitwise `repro`'s. `repro` simulates its series with
JAX's threefry generator, which has no PyTorch twin; the port simulates them
with its counter-hash engine (`repro_torch.epi.engine.simulate_observed`)
from the same seeds. To feed both packages one series, build the port's
`CountryData` from `repro`'s arrays with
`repro_torch.convert.country_data_from_arrays`.

Series are always simulated on the CPU, so a dataset is the same whichever
device later fits it. The country series are SIARD's; any model that
observes the same (A, R, D) channels (seiard) fits them, as in `repro`.
`synthetic_small` drawn for a regional model holds [R * n_observed, T]
region-major rows, labelled `I@r0`, `R@r0`, `I@r1`, ... (the spec's
`observed_labels`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.epi import engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import CompartmentalModel, EpiModelConfig, active_schedule


@dataclasses.dataclass(frozen=True)
class CountryData:
    name: str
    population: float
    a0: float
    r0: float
    d0: float
    observed: np.ndarray  # [total_observed, T] float32, region-major
    #: tolerance the paper used for this dataset (Table 8), where applicable
    paper_tolerance: float | None = None
    #: generating parameters if synthetic, else None
    true_theta: Tuple[float, ...] | None = None
    synthetic: bool = True
    #: registry name of the model whose observed channels the rows match
    model: str = "siard"
    observed_channels: Tuple[str, ...] = ("A", "R", "D")

    @property
    def num_days(self) -> int:
        return int(self.observed.shape[1])

    def model_config(self, num_days: int | None = None) -> EpiModelConfig:
        return EpiModelConfig(
            population=self.population,
            num_days=int(num_days or self.num_days),
            a0=self.a0,
            r0=self.r0,
            d0=self.d0,
        )

    def compatible_with(self, spec: CompartmentalModel) -> bool:
        """A spec can fit this dataset iff its observed channels line up."""
        return spec.observed_labels == self.observed_channels


def synthetic_dataset(
    theta: Tuple[float, ...],
    population: float,
    num_days: int = 49,
    a0: float = 100.0,
    r0: float = 0.0,
    d0: float = 0.0,
    seed: int = 0,
    name: str = "synthetic",
    paper_tolerance: float | None = None,
    model: Union[str, CompartmentalModel] = "siard",
    schedule=None,
) -> CountryData:
    """Simulate a ground-truth dataset from known parameters (hash RNG, CPU).

    `schedule` (an InterventionSchedule with fixed scales) simulates the
    series under a known intervention; `theta` is the base parameters and
    the schedule's pinned scales are appended (or pass the widened theta).
    """
    spec = get_model(model)
    th = np.asarray([theta], np.float32)
    width = spec.n_params
    schedule = active_schedule(schedule)
    if schedule is not None:
        width = schedule.param_width(spec)
        if th.shape[1] == spec.n_params:
            scales = np.asarray([x for row in schedule.fixed_scales() for x in row],
                                np.float32)
            th = np.concatenate([th, scales[None, :]], axis=1)
    if th.shape[1] != width:
        raise ValueError(
            f"theta has {th.shape[1]} entries; model {spec.name!r} "
            f"expects {width}"
        )
    cfg = EpiModelConfig(
        population=population, num_days=num_days, a0=a0, r0=r0, d0=d0
    )
    obs = engine.simulate_observed(spec, torch.from_numpy(th), seed, cfg, schedule)[0]
    return CountryData(
        name=name,
        population=population,
        a0=a0,
        r0=r0,
        d0=d0,
        observed=obs.numpy().astype(np.float32),
        paper_tolerance=paper_tolerance,
        true_theta=tuple(float(x) for x in theta),
        synthetic=True,
        model=spec.name,
        observed_channels=spec.observed_labels,
    )


# Paper Table 8 posterior means: generating parameters of the demo series
TABLE8_THETA = {
    "italy": (0.384, 36.054, 0.595, 0.013, 0.385, 0.009, 0.477, 0.830),
    "new_zealand": (0.474, 46.603, 1.223, 0.030, 0.499, 0.001, 0.520, 1.198),
    "usa": (0.329, 10.667, 0.322, 0.007, 0.435, 0.005, 0.490, 0.716),
}

# (population, A0, R0, D0, paper tolerance, seed)
COUNTRY_META = {
    "italy": (60.36e6, 155.0, 2.0, 3.0, 5e4, 1),
    "new_zealand": (4.917e6, 102.0, 0.0, 0.0, 1250.0, 2),
    "usa": (328.2e6, 104.0, 7.0, 6.0, 2e5, 3),
}

#: (population, A0, R0, D0, seed) and generating theta of synthetic_small
SYNTH_SMALL_META = (1e6, 100.0, 0.0, 0.0, 7)
SYNTH_SMALL_THETA = (0.4, 30.0, 0.8, 0.05, 0.3, 0.01, 0.5, 1.0)

_CACHE: Dict[tuple, CountryData] = {}


def list_datasets() -> Tuple[str, ...]:
    return tuple(sorted(COUNTRY_META)) + ("synthetic_small",)


def get_dataset(
    name: str,
    num_days: int = 49,
    model: Union[str, CompartmentalModel] = "siard",
) -> CountryData:
    """Fetch a dataset by name ('italy' | 'new_zealand' | 'usa' |
    'synthetic_small')."""
    spec = get_model(model)
    # keyed by the spec itself: two regionalized specs of one name differ
    key = (name, num_days, spec)
    if key in _CACHE:
        return _CACHE[key]
    if name == "synthetic_small":
        population, a0, r0, d0, seed = SYNTH_SMALL_META
        theta = SYNTH_SMALL_THETA if spec.name == "siard" else spec.default_theta
        ds = synthetic_dataset(
            theta=theta, population=population, num_days=num_days,
            a0=a0, r0=r0, d0=d0, seed=seed, name="synthetic_small", model=spec,
        )
    elif name in COUNTRY_META:
        if spec.name != "siard":
            # the series stays SIARD's; a model that observes the same
            # channels fits it, re-tagged (no new simulation)
            base = get_dataset(name, num_days=num_days, model="siard")
            if not base.compatible_with(spec):
                raise ValueError(
                    f"dataset {name!r} holds (A, R, D) series; model "
                    f"{spec.name!r} observes {spec.observed_labels}"
                )
            ds = dataclasses.replace(base, model=spec.name, true_theta=None)
            _CACHE[key] = ds
            return ds
        population, a0, r0, d0, tol, seed = COUNTRY_META[name]
        ds = synthetic_dataset(
            theta=TABLE8_THETA[name], population=population,
            num_days=num_days, a0=a0, r0=r0, d0=d0, seed=seed, name=name,
            paper_tolerance=tol, model="siard",
        )
    else:
        raise KeyError(f"unknown dataset {name!r}; available: {list_datasets()}")
    _CACHE[key] = ds
    return ds
