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
kernel carries each model as a C++ struct (`kernels/csrc/<model>.cuh`).

An `InterventionSchedule` scales chosen parameters by a factor per window of
days; the scales are extra columns of theta. Metapopulation regions raise
`NotImplementedError`: the region axis is queue 1, item 4 of ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence, Tuple

Rows = Sequence
HazardFn = Callable[[Rows, Rows, object], Tuple]
InitialFn = Callable[[Rows, object, object, object, object], Tuple]

#: hash-RNG counter slots per simulated day (5 used by SIARD)
CTR_SLOTS = 8
#: most windows a schedule may have (the kernel's breakpoint lanes)
MAX_WINDOWS = 16


def require_flat(n_regions: int = 1) -> None:
    """Raise for a metapopulation model: the port has no region axis yet."""
    if n_regions != 1:
        raise NotImplementedError(
            "metapopulation models (n_regions > 1) wait for the region axis "
            "(queue 1, item 4 of ROADMAP.md)"
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
    #: metapopulation regions; the port carries 1
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


class ScheduleShape(NamedTuple):
    """The part of a schedule that shapes the computation: the window count
    and which parameters are scaled. Breakpoint days and scales are run-time
    values, so schedules of one shape share one build of the kernel."""

    n_windows: int
    tv_indices: Tuple[int, ...]  # positions of the scaled params in param_names

    @property
    def n_tv(self) -> int:
        return len(self.tv_indices)

    @property
    def n_scales(self) -> int:
        return self.n_windows * self.n_tv


@dataclasses.dataclass(frozen=True)
class InterventionSchedule:
    """Piecewise-constant scaling of chosen parameters (port of
    `repro.epi.spec.InterventionSchedule`).

    Day d falls in window `w = #{i : d >= breakpoints[i]}`: window 0 uses the
    base parameters unscaled; window w >= 1 multiplies each parameter named
    in `tv_params` by that window's scale. The scales are inferred like the
    parameters: theta widens from [n_params] to [n_params + n_windows * n_tv],
    the base parameters followed by window-major scale blocks (w1: tv_0 ..
    tv_{n_tv-1}, w2: ...). Each scale has a uniform prior [scale_lows[w][j],
    scale_highs[w][j]]; a zero-width box pins it to a known value.
    """

    #: names of the scaled ("time-varying") parameters, subset of param_names
    tv_params: Tuple[str, ...]
    #: strictly increasing, positive day indices; window i+1 starts at day
    #: breakpoints[i]. n_windows == len(breakpoints).
    breakpoints: Tuple[int, ...]
    #: per-window scale prior bounds, [n_windows][n_tv]
    scale_lows: Tuple[Tuple[float, ...], ...]
    scale_highs: Tuple[Tuple[float, ...], ...]

    def __post_init__(self):
        object.__setattr__(self, "tv_params", tuple(self.tv_params))
        object.__setattr__(self, "breakpoints", tuple(int(b) for b in self.breakpoints))
        object.__setattr__(self, "scale_lows",
                           tuple(tuple(float(x) for x in row) for row in self.scale_lows))
        object.__setattr__(self, "scale_highs",
                           tuple(tuple(float(x) for x in row) for row in self.scale_highs))
        nw, nt = len(self.breakpoints), len(self.tv_params)
        if nw and not nt:
            raise ValueError("schedule has breakpoints but no tv_params")
        if nt and not nw:
            raise ValueError("schedule has tv_params but no breakpoints")
        if len(set(self.tv_params)) != nt:
            raise ValueError(f"tv_params name a parameter twice: {self.tv_params}")
        if any(b <= 0 for b in self.breakpoints):
            raise ValueError(f"breakpoints must be positive days: {self.breakpoints}")
        if any(b2 <= b1 for b1, b2 in zip(self.breakpoints, self.breakpoints[1:])):
            raise ValueError(f"breakpoints must be strictly increasing: {self.breakpoints}")
        if len(self.scale_lows) != nw or len(self.scale_highs) != nw:
            raise ValueError(f"need {nw} scale bound rows, one per window")
        for lo_row, hi_row in zip(self.scale_lows, self.scale_highs):
            if len(lo_row) != nt or len(hi_row) != nt:
                raise ValueError(f"each scale bound row must have {nt} entries")
            if any(h < lo for lo, h in zip(lo_row, hi_row)):
                raise ValueError("scale_highs must be >= scale_lows")
        if nw > MAX_WINDOWS:
            raise ValueError(
                f"at most {MAX_WINDOWS} intervention windows supported, got {nw}")

    @staticmethod
    def fixed(tv_params, breakpoints, scales) -> "InterventionSchedule":
        """Known scales: `scales` is [n_windows][n_tv], or a flat [n_windows]
        sequence when there is a single tv param."""
        rows = tuple(
            (float(s),) if not isinstance(s, (tuple, list)) else tuple(s) for s in scales
        )
        return InterventionSchedule(tuple(tv_params), tuple(breakpoints), rows, rows)

    @staticmethod
    def inferred(tv_params, breakpoints, low: float = 0.0,
                 high: float = 2.0) -> "InterventionSchedule":
        """Unknown scales, inferred by ABC under U(low, high) per window."""
        nt = len(tuple(tv_params))
        return InterventionSchedule(
            tuple(tv_params), tuple(breakpoints),
            tuple((float(low),) * nt for _ in breakpoints),
            tuple((float(high),) * nt for _ in breakpoints),
        )

    @property
    def n_windows(self) -> int:
        return len(self.breakpoints)

    @property
    def n_tv(self) -> int:
        return len(self.tv_params)

    @property
    def n_scales(self) -> int:
        return self.n_windows * self.n_tv

    @property
    def is_empty(self) -> bool:
        return self.n_windows == 0

    def shape(self, model: CompartmentalModel) -> ScheduleShape:
        """The window count and scaled positions; checks tv_params against
        the model."""
        idx = []
        for name in self.tv_params:
            if name not in model.param_names:
                raise ValueError(
                    f"schedule scales {name!r}, which is not a parameter of "
                    f"model {model.name!r} ({model.param_names})"
                )
            idx.append(model.param_names.index(name))
        return ScheduleShape(n_windows=self.n_windows, tv_indices=tuple(idx))

    def param_width(self, model: CompartmentalModel) -> int:
        return model.n_params + self.n_scales

    def scale_param_names(self) -> Tuple[str, ...]:
        """Names of the widened theta columns, window-major: alpha_w1, ..."""
        return tuple(f"{p}_w{w + 1}" for w in range(self.n_windows) for p in self.tv_params)

    def param_names(self, model: CompartmentalModel) -> Tuple[str, ...]:
        return model.param_names + self.scale_param_names()

    def fixed_scales(self) -> Tuple[Tuple[float, ...], ...]:
        """The pinned scale values; raises if any window's scales are inferred."""
        for lo_row, hi_row in zip(self.scale_lows, self.scale_highs):
            if any(h > lo for lo, h in zip(lo_row, hi_row)):
                raise ValueError(
                    "schedule has inferred (non-degenerate) scale priors; "
                    "fixed_scales() needs every low == high"
                )
        return self.scale_lows

    def tag(self) -> str:
        """Compact filesystem-safe label for scenario/checkpoint names."""
        if self.is_empty:
            return "none"
        wins = []
        for w, b in enumerate(self.breakpoints):
            parts = [f"{lo:g}" if lo == h else f"{lo:g}to{h:g}"
                     for lo, h in zip(self.scale_lows[w], self.scale_highs[w])]
            wins.append(f"d{b}s" + "+".join(parts))
        return "iv_" + "+".join(self.tv_params) + "_" + "_".join(wins)


#: the no-op schedule: simulating under it is bitwise schedule=None
EMPTY_SCHEDULE = InterventionSchedule(tv_params=(), breakpoints=(), scale_lows=(),
                                      scale_highs=())


def active_schedule(schedule) -> "InterventionSchedule | None":
    """`schedule` if it has windows, None for None or an empty one; raises
    TypeError for anything that is not an `InterventionSchedule`."""
    if schedule is None:
        return None
    if not isinstance(schedule, InterventionSchedule):
        raise TypeError(f"schedule must be an InterventionSchedule or None, got "
                        f"{type(schedule).__name__}")
    return None if schedule.is_empty else schedule


@dataclasses.dataclass(frozen=True)
class EpiModelConfig:
    """Static simulation configuration."""

    population: float  # P: total population at day 0
    num_days: int  # T: simulation horizon (the paper fits 49 days)
    a0: float = 100.0
    r0: float = 0.0
    d0: float = 0.0
