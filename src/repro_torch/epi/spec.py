"""Declarative specification of a stochastic compartmental model (port).

The port's copy of `repro.epi.spec`. A `CompartmentalModel` names its
compartments and parameters, lists its transitions as a stoichiometry
matrix and gives two row-level functions:

    h   = hazard_rows(state_rows, param_rows, population)   one rate per transition
    n_k = floor(h_k + sqrt(h_k) * z_k)                       Gaussian tau-leap counts
    n_k = clip(n_k, 0, remaining[source_k])                  sequential source draining
    x'  = x + stoichiometry^T @ n                            apply transitions

Rows are sequences of same-shape tensors, one per compartment or parameter,
so the same function body serves the engine (`repro_torch.epi.engine`) and
the plain version of the fused kernel (`repro_torch.kernels.ref`). The CUDA
kernel carries each model's rows as a C++ struct (`kernels/csrc/<kernel>.cuh`,
`CompartmentalModel.kernel`).

Spatial metapopulation models declare `n_regions` (R) copies of their
compartments coupled through a `mobility` matrix: row-stochastic weights by
default, or daily traveller counts (`mobility_counts`; entry [r][q] the
travellers from region q to region r, non-negative and finite). State,
transitions and observed channels flatten region-major: channel
`r * n_state + c` is compartment c of region r. For each compartment named
in `coupled`, a hazard sees one extra row after its local ones, the
mobility-weighted mass `sum_q mobility[r][q] * x_q`, where x is the
compartment itself or, with a `coupled_inputs` hook, the row the hook
makes of it (a traveller model divides each compartment by the region's
population less its documented cases). A `region_constants` hook adds
rows worked out once from the matrix and the populations (a region's
outbound travellers), after the coupled rows. Each region holds
population / R people, or its own of `populations`; the dataset's (a0, r0,
d0) seed `seed_region` only. A transition row with a +1 and no -1 is an
inflow (travellers arriving), one with a -1 and no +1 an outflow; only a
regional spec has them. At R=1 with nothing coupled every total equals its
per-region count, so a flat model is the R=1 case (`is_regional` is False).

An `InterventionSchedule` scales chosen parameters by a factor per window of
days; the scales are extra columns of theta, shared by every region.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence, Tuple

Rows = Sequence
HazardFn = Callable[[Rows, Rows, object], Tuple]
InitialFn = Callable[[Rows, object, object, object, object], Tuple]
#: (state rows, population row) -> the rows the mobility matrix multiplies
CoupledInputsFn = Callable[[Rows, object], Tuple]
#: (mobility [R, R], population row) -> [R] rows worked out once
RegionConstantsFn = Callable[[object, object], Tuple]

#: hash-RNG counter slots per simulated day of a flat model (5 used by
#: SIARD); a regional model's stride is `CompartmentalModel.ctr_slots`
CTR_SLOTS = 8
#: most transitions a model may have, per region (a flat model: `CTR_SLOTS`,
#: its day's counter slots)
MAX_TRANSITIONS = 16
#: most windows a schedule may have (the kernel's breakpoint lanes)
MAX_WINDOWS = 16
#: tolerance of the row sums of a mobility matrix (float32 inputs)
_ROW_SUM_TOL = 1e-5


def identity_mobility(n_regions: int) -> Tuple[Tuple[float, ...], ...]:
    """The zero-coupling matrix: every region keeps all of its own mass."""
    return tuple(
        tuple(1.0 if q == r else 0.0 for q in range(n_regions))
        for r in range(n_regions)
    )


def validate_mobility(mobility, n_regions: int,
                      counts: bool = False) -> Tuple[Tuple[float, ...], ...]:
    """A mobility matrix as nested float tuples, checked: [R][R], rows of
    non-negative entries that sum to 1 (row-stochastic), or with `counts`
    non-negative finite traveller counts. Raises ValueError otherwise."""
    rows = tuple(tuple(float(x) for x in row) for row in mobility)
    if len(rows) != n_regions or any(len(r) != n_regions for r in rows):
        raise ValueError(
            f"mobility must be a [{n_regions}][{n_regions}] matrix, got "
            f"shape ({len(rows)}, {tuple(len(r) for r in rows)})"
        )
    for r, row in enumerate(rows):
        if counts:
            if not all(0.0 <= x < math.inf for x in row):
                raise ValueError(
                    f"mobility row {r} holds a negative or non-finite traveller "
                    "count: counts must be finite and non-negative"
                )
            continue
        if any(x < 0.0 for x in row):
            raise ValueError(
                f"mobility row {r} has negative entries: {row} — rows must "
                "be non-negative probabilities"
            )
        s = sum(row)
        if abs(s - 1.0) > _ROW_SUM_TOL:
            raise ValueError(
                f"mobility row {r} sums to {s!r}, not 1: mobility must be "
                "row-stochastic (each region's mass weights sum to 1)"
            )
    return rows


def make_mobility(spec: str, n_regions: int) -> Tuple[Tuple[float, ...], ...]:
    """A mobility matrix from the CLI grammar (--mobility):

      * "identity"     no coupling between regions
      * "uniform:EPS"  each region keeps 1-EPS and spreads EPS evenly over
                       the other R-1 regions
      * "ring:EPS"     each region keeps 1-EPS and sends EPS/2 to each of
                       its two ring neighbours (EPS to the other of two)
    """
    kind, _, arg = spec.partition(":")
    if kind == "identity":
        if arg:
            raise ValueError(f"identity mobility takes no argument: {spec!r}")
        return identity_mobility(n_regions)
    if kind not in ("uniform", "ring"):
        raise ValueError(
            f"unknown mobility kind {spec!r}; grammar: identity | "
            "uniform:EPS | ring:EPS"
        )
    if not arg:
        raise ValueError(f"mobility {kind!r} needs a coupling strength: {spec!r}")
    eps = float(arg)
    if not 0.0 <= eps <= 1.0:
        raise ValueError(f"mobility coupling must be in [0, 1], got {eps}")
    if n_regions == 1:
        return identity_mobility(1)
    rows = []
    for r in range(n_regions):
        row = [0.0] * n_regions
        row[r] = 1.0 - eps
        if kind == "uniform":
            for q in range(n_regions):
                if q != r:
                    row[q] = eps / (n_regions - 1)
        elif n_regions == 2:
            row[(r + 1) % 2] = eps
        else:
            row[(r - 1) % n_regions] += eps / 2.0
            row[(r + 1) % n_regions] += eps / 2.0
        rows.append(tuple(row))
    return validate_mobility(rows, n_regions)


@dataclasses.dataclass(frozen=True)
class CompartmentalModel:
    """Declarative spec of a stochastic compartmental epidemic model."""

    name: str
    compartments: Tuple[str, ...]
    param_names: Tuple[str, ...]
    #: uniform-box prior upper bounds, one per parameter (lows default to 0)
    prior_highs: Tuple[float, ...]
    #: [n_transitions][n_state]: each row moves one unit out of one source
    #: (-1) into one destination (+1), or, on a regional spec, into one
    #: compartment from outside (an inflow, no -1) or out of one (an
    #: outflow, no +1); row order is the clamp order
    stoichiometry: Tuple[Tuple[int, ...], ...]
    #: names of observed compartments, compared against data [n_observed, T]
    observed: Tuple[str, ...]
    hazard_rows: HazardFn
    initial_rows: InitialFn
    #: operations of one `hazard_rows` evaluation per sample-day (per region),
    #: before the clamp at zero, with products of parameters alone counted
    #: once per sample and left out (the kernel's bound, `kernels.abc_sim`)
    hazard_ops: int
    #: plausible generating parameters
    default_theta: Tuple[float, ...]
    prior_lows: Tuple[float, ...] | None = None
    doc: str = ""
    #: metapopulation regions; R=1 is the flat single-population layout
    n_regions: int = 1
    #: [R][R] coupling: mobility[r][q] weights region q's mass in region r's
    #: coupled rows, row-stochastic or, with `mobility_counts`, the daily
    #: travellers from q to r. None becomes the identity (no coupling)
    #: whenever regions or coupled compartments are declared.
    mobility: Tuple[Tuple[float, ...], ...] | None = None
    #: compartments whose mobility-weighted mass rows are appended, in this
    #: order, to the state rows `hazard_rows` sees
    coupled: Tuple[str, ...] = ()
    #: the region seeded with the dataset's (a0, r0, d0); every other region
    #: starts fully susceptible at its population
    seed_region: int = 0
    #: `mobility` holds traveller counts (finite, non-negative) and not
    #: row-stochastic weights
    mobility_counts: bool = False
    #: each region's population, [R]; None: population / R each
    populations: Tuple[float, ...] | None = None
    #: (state rows, population row) -> the rows that the matrix multiplies,
    #: one a coupled compartment; None: the coupled compartments themselves
    coupled_inputs: CoupledInputsFn | None = None
    #: (mobility [R, R] float32, population row) -> [R] float32 rows that
    #: `hazard_rows` sees after the coupled rows; None: no such row
    region_constants: RegionConstantsFn | None = None
    #: the C++ struct (`kernels/csrc/<kernel>.cuh`) that carries these rows
    #: in the CUDA kernel; "" is `name`. `regionalize` keeps it, so a spec
    #: renamed `seir_r3` still runs on seir's struct.
    kernel: str = ""

    def __post_init__(self):
        ns, np_, nt = len(self.compartments), len(self.param_names), len(self.stoichiometry)
        if len(self.prior_highs) != np_:
            raise ValueError(f"{self.name}: prior_highs must have {np_} entries")
        if self.prior_lows is not None and len(self.prior_lows) != np_:
            raise ValueError(f"{self.name}: prior_lows must have {np_} entries")
        if len(self.default_theta) != np_:
            raise ValueError(f"{self.name}: default_theta must have {np_} entries")
        regional = self.n_regions > 1 or bool(self.coupled)
        moves = sorted((-1, 1) + (0,) * (ns - 2))
        ends = (sorted((-1,) + (0,) * (ns - 1)), sorted((1,) + (0,) * (ns - 1)))
        for k, row in enumerate(self.stoichiometry):
            if len(row) != ns or (sorted(row) != moves
                                  and not (regional and sorted(row) in ends)):
                raise ValueError(
                    f"{self.name}: transition {k} must move one unit from one "
                    "source to one destination (or, on a regional spec, into or "
                    f"out of one compartment alone), got {row}"
                )
        for name in self.observed:
            if name not in self.compartments:
                raise ValueError(f"{self.name}: observed {name!r} is not a compartment")
        # per region: a regional model widens the day's counter stride
        # (`ctr_slots`); a flat one has the day's CTR_SLOTS slots
        most = MAX_TRANSITIONS if regional else CTR_SLOTS
        if nt > most:
            raise ValueError(f"{self.name}: at most {most} transitions supported, got {nt}")
        if not self.kernel:
            object.__setattr__(self, "kernel", self.name)
        # ---- the region axis
        if not isinstance(self.n_regions, int) or self.n_regions < 1:
            raise ValueError(
                f"{self.name}: n_regions must be a positive int, got "
                f"{self.n_regions!r}"
            )
        object.__setattr__(self, "coupled", tuple(self.coupled))
        for name in self.coupled:
            if name not in self.compartments:
                raise ValueError(f"{self.name}: coupled {name!r} is not a compartment")
        if not 0 <= self.seed_region < self.n_regions:
            raise ValueError(
                f"{self.name}: seed_region {self.seed_region} out of range "
                f"for {self.n_regions} regions"
            )
        if self.mobility is None:
            if self.coupled or self.n_regions > 1:
                object.__setattr__(self, "mobility", identity_mobility(self.n_regions))
        else:
            object.__setattr__(
                self, "mobility",
                validate_mobility(self.mobility, self.n_regions, self.mobility_counts),
            )
        if self.populations is not None:
            pops = tuple(float(x) for x in self.populations)
            if len(pops) != self.n_regions or not all(0.0 < x < math.inf for x in pops):
                raise ValueError(
                    f"{self.name}: populations must be {self.n_regions} positive finite "
                    f"numbers, one a region, got {len(pops)}"
                )
            object.__setattr__(self, "populations", pops)

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
    def transition_sources(self) -> Tuple[int | None, ...]:
        """Source compartment index of each transition (the -1 entry); None
        for an inflow."""
        return tuple(row.index(-1) if -1 in row else None for row in self.stoichiometry)

    @property
    def transition_destinations(self) -> Tuple[int | None, ...]:
        """Destination compartment index of each transition (the +1 entry);
        None for an outflow."""
        return tuple(row.index(1) if 1 in row else None for row in self.stoichiometry)

    # region-major totals: at R=1 each equals its per-region count
    @property
    def total_state(self) -> int:
        return self.n_regions * self.n_state

    @property
    def total_transitions(self) -> int:
        return self.n_regions * self.n_transitions

    @property
    def total_observed(self) -> int:
        return self.n_regions * self.n_observed

    @property
    def total_observed_idx(self) -> Tuple[int, ...]:
        """Observed channel indices into the region-major state."""
        return tuple(r * self.n_state + c for r in range(self.n_regions)
                     for c in self.observed_idx)

    @property
    def observed_labels(self) -> Tuple[str, ...]:
        """Labels of the observed rows of a dataset: the compartment names
        at R=1, `C@rN` region-major else."""
        if self.n_regions == 1:
            return self.observed
        return tuple(f"{c}@r{r}" for r in range(self.n_regions) for c in self.observed)

    @property
    def coupled_idx(self) -> Tuple[int, ...]:
        return tuple(self.compartments.index(c) for c in self.coupled)

    @property
    def is_regional(self) -> bool:
        """True unless the spec is flat (R=1, nothing coupled): a regional
        spec runs the region path of the engine and of the kernel."""
        return self.n_regions > 1 or bool(self.coupled)

    @property
    def ctr_slots(self) -> int:
        """Hash-RNG counter slots a day: 8 at R=1 (the flat stream), the
        total transitions rounded up to a multiple of 8 above it. Region
        r's transition k draws slot r * n_transitions + k."""
        return max(CTR_SLOTS, -(-self.total_transitions // 8) * 8)

    def prior(self):
        """The model's uniform box prior U(lows, highs)."""
        from repro_torch.core.priors import UniformBoxPrior

        return UniformBoxPrior(highs=self.prior_highs, lows=self.prior_lows)


def regionalize(
    model: CompartmentalModel,
    n_regions: int,
    mobility=None,
    name: str | None = None,
    seed_region: int = 0,
) -> CompartmentalModel:
    """A spatial variant of `model` with R regions coupled by `mobility`: a
    matrix, a `make_mobility` string ("ring:0.1") or None (identity). The
    rows are unchanged; only a model with coupled compartments exchanges
    mass, any other becomes R independent copies. The spec checks the
    matrix, as weights or, for a spec of `mobility_counts`, as traveller
    counts. The name becomes `<name>_r<R>` when R changes, and the
    populations are dropped (population / R each); the struct of the CUDA
    kernel (`kernel`) stays."""
    if isinstance(mobility, str):
        mobility = make_mobility(mobility, n_regions)
    same = n_regions == model.n_regions
    return dataclasses.replace(
        model,
        name=name or (model.name if same else f"{model.name}_r{n_regions}"),
        n_regions=n_regions,
        mobility=mobility,
        seed_region=seed_region,
        populations=model.populations if same else None,
    )


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
