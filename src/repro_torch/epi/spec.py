"""Declarative specification of a stochastic compartmental model (port).

The port's copy of the flat part of `repro.epi.spec`. A `CompartmentalModel`
names its compartments and parameters, lists its transitions as a
stoichiometry matrix and gives two row-level functions:

    h   = hazard_rows(state_rows, param_rows, population)   one rate per transition
    n_k = floor(h_k + sqrt(h_k) * z_k)                       Gaussian tau-leap counts
    n_k = clip(n_k, 0, remaining[source_k])                  sequential source draining
    x'  = x + stoichiometry^T @ n                            apply transitions

Rows are sequences of same-shape tensors, one per compartment or parameter,
so the same function body serves the engine (`repro_torch.epi.engine`) and
the plain version of the fused kernel (`repro_torch.kernels.ref`). The CUDA
kernel carries the same model as a C++ struct (`kernels/csrc/siard.cuh`).

This slice ports flat models only: metapopulation regions and intervention
schedules raise `NotImplementedError` and arrive in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

Rows = Sequence
HazardFn = Callable[[Rows, Rows, object], Tuple]
InitialFn = Callable[[Rows, object, object, object, object], Tuple]

#: hash-RNG counter slots per simulated day (5 used by SIARD)
CTR_SLOTS = 8

_LATER_SLICE = "a later slice of the port (queue 1, item 8 of ROADMAP.md)"


def require_flat(n_regions: int = 1, schedule=None) -> None:
    """Raise for what this slice of the port does not carry yet."""
    if schedule is not None and not getattr(schedule, "is_empty", False):
        raise NotImplementedError(
            f"intervention schedules arrive in {_LATER_SLICE}"
        )
    if n_regions != 1:
        raise NotImplementedError(
            f"metapopulation models (n_regions > 1) arrive in {_LATER_SLICE}"
        )


@dataclasses.dataclass(frozen=True)
class CompartmentalModel:
    """Declarative spec of a flat stochastic compartmental epidemic model."""

    name: str
    compartments: Tuple[str, ...]
    param_names: Tuple[str, ...]
    #: uniform-box prior upper bounds, one per parameter (lows default to 0)
    prior_highs: Tuple[float, ...]
    #: [n_transitions][n_state]: each row moves one unit out of one source
    #: (-1) into one destination (+1); row order is the clamp order
    stoichiometry: Tuple[Tuple[int, ...], ...]
    #: names of observed compartments, compared against data [n_observed, T]
    observed: Tuple[str, ...]
    hazard_rows: HazardFn
    initial_rows: InitialFn
    #: operations of one `hazard_rows` evaluation per sample-day, before the
    #: clamp at zero, with products of parameters alone counted once per
    #: sample and left out (the kernel's bound, `kernels.abc_sim`)
    hazard_ops: int
    #: plausible generating parameters
    default_theta: Tuple[float, ...]
    prior_lows: Tuple[float, ...] | None = None
    doc: str = ""
    #: metapopulation regions; only 1 is carried by this slice
    n_regions: int = 1

    def __post_init__(self):
        require_flat(self.n_regions)
        ns, np_ = len(self.compartments), len(self.param_names)
        if len(self.prior_highs) != np_:
            raise ValueError(f"{self.name}: prior_highs must have {np_} entries")
        if self.prior_lows is not None and len(self.prior_lows) != np_:
            raise ValueError(f"{self.name}: prior_lows must have {np_} entries")
        if len(self.default_theta) != np_:
            raise ValueError(f"{self.name}: default_theta must have {np_} entries")
        for k, row in enumerate(self.stoichiometry):
            if len(row) != ns or sorted(row) != sorted((-1, 1) + (0,) * (ns - 2)):
                raise ValueError(
                    f"{self.name}: transition {k} must move one unit from one "
                    f"source to one destination, got {row}"
                )
        for name in self.observed:
            if name not in self.compartments:
                raise ValueError(f"{self.name}: observed {name!r} is not a compartment")
        if len(self.stoichiometry) > CTR_SLOTS:
            raise ValueError(
                f"{self.name}: at most {CTR_SLOTS} transitions supported, "
                f"got {len(self.stoichiometry)}"
            )

    @property
    def n_state(self) -> int:
        return len(self.compartments)

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    @property
    def n_transitions(self) -> int:
        return len(self.stoichiometry)

    @property
    def n_observed(self) -> int:
        return len(self.observed)

    @property
    def observed_idx(self) -> Tuple[int, ...]:
        return tuple(self.compartments.index(c) for c in self.observed)

    @property
    def transition_sources(self) -> Tuple[int, ...]:
        """Source compartment index of each transition (the -1 entry)."""
        return tuple(row.index(-1) for row in self.stoichiometry)

    @property
    def observed_labels(self) -> Tuple[str, ...]:
        """Per-channel labels of the observed rows of a dataset."""
        return self.observed

    def prior(self):
        """The model's uniform box prior U(lows, highs)."""
        from repro_torch.core.priors import UniformBoxPrior

        return UniformBoxPrior(highs=self.prior_highs, lows=self.prior_lows)


@dataclasses.dataclass(frozen=True)
class EpiModelConfig:
    """Static simulation configuration."""

    population: float  # P: total population at day 0
    num_days: int  # T: simulation horizon (the paper fits 49 days)
    a0: float = 100.0
    r0: float = 0.0
    d0: float = 0.0
