"""Generic tau-leap engine over a `CompartmentalModel` spec (port).

The port's counterpart of `repro.epi.engine`, with intervention schedules
(`effective_param_rows`) and the region axis of metapopulation models.
Functions take tensors on
any device and keep them there; every scalar that meets a tensor becomes a
float32 tensor on that tensor's device first (`_f32`), so that a division
by the population rounds the same way on the CPU and on the card.

`drain_and_apply` stays row-level: it is the mass-conservation contract.
Transitions are clamped in declaration order with sequential source
draining, so no compartment goes negative and the total is conserved.

A regional spec (`model.is_regional`) keeps its state region-major,
[..., R * n_state], and works on rows [..., R] with the parameters as rows
[..., 1]. Each region holds population / R, divided in float32 as the TPU
kernel divides it (`repro`'s engine divides the Python float), or its own
of the spec's `populations`. A coupled row is `mob[r][0] * x_0 + mob[r][1]
* x_1 + ...`, summed left to right from the first product as the TPU kernel
body sums it, one [..., R] operation a source region q (`coupled_rows`);
`repro`'s engine uses an einsum, whose order is not the kernel's. x is the
coupled compartment, or the row the spec's `coupled_inputs` makes of the
state; the rows of `region_constants` follow the coupled rows.

`simulate_observed` draws its noise from the counter-hash RNG
(`repro_torch.kernels.rng`), the same stream as the fused kernel: region r's
transition k on day d is slot r * n_transitions + k of the day's
`model.ctr_slots`. The JAX package's threefry streams have no PyTorch twin.

The seed, the dataset scalars (population, a0, r0, d0) and the schedule's
breakpoint days are run-time values of `simulate_observed`: each may be a
Python scalar or a tensor with one row a sample, so one call can simulate
the particles of many forecast queries as one batch (`core/serving.py`),
each row bitwise what a call of its own would give.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.epi.spec import (
    CompartmentalModel,
    EpiModelConfig,
    InterventionSchedule,
    ScheduleShape,
    active_schedule,
    identity_mobility,
)
from repro_torch.kernels import rng as krng


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float or tensor as a float32 tensor on `like`'s device. A Python
    or numpy number is filled in on the device (the same float32 rounding
    as a copy), so that no host-to-device copy, which PyTorch follows with
    a stream sync, stalls the host on the card."""
    if isinstance(x, (int, float, np.integer, np.floating)):
        return torch.full((), float(x), dtype=torch.float32, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=256)
def _index(idx: tuple, device: torch.device) -> torch.Tensor:
    """An index tuple as an int64 tensor on `device`, copied there once."""
    return torch.tensor(idx, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=16)
def _populations(pops: tuple, device: torch.device) -> torch.Tensor:
    """A spec's populations as a float32 tensor on `device`, copied there
    once."""
    return torch.tensor(pops, dtype=torch.float32, device=device)


def mobility_matrix(model: CompartmentalModel, mobility=None,
                    device=None) -> torch.Tensor:
    """The [R, R] float32 coupling: an override, the spec's matrix, or the
    identity."""
    mob = model.mobility if mobility is None else mobility
    if mob is None:
        mob = identity_mobility(model.n_regions)
    return torch.as_tensor(mob, dtype=torch.float32, device=device)


def _region_rows(x, like: torch.Tensor) -> torch.Tensor:
    """A dataset scalar against [..., R] rows: float32, and a per-sample
    tensor [B] as [B, 1]."""
    x = _f32(x, like)
    return x.unsqueeze(-1) if x.ndim else x


def region_population(model: CompartmentalModel, population, like: torch.Tensor):
    """A region's population as a float32 tensor: the spec's `populations`
    [R] where it has them, else population / R in float32 for R > 1 and the
    population itself at R=1."""
    if model.populations is not None:
        return _populations(model.populations, like.device)
    pop = _region_rows(population, like)
    return pop / model.n_regions if model.n_regions > 1 else pop


def seed_vector(model: CompartmentalModel, value, like: torch.Tensor) -> torch.Tensor:
    """[R] day-0 counts ([B, R] for a per-sample `value`): `value` * 1 in
    `seed_region`, `value` * 0 in every other region, each product in
    float32 as the kernels form it."""
    z = torch.zeros((model.n_regions,), dtype=torch.float32, device=like.device)
    z[model.seed_region] = 1.0
    return _region_rows(value, like) * z


def initial_state(
    model: CompartmentalModel, theta: torch.Tensor, cfg: EpiModelConfig
) -> torch.Tensor:
    """Spec step 1: theta [..., n_params] -> state [..., total_state].

    A regional spec seeds `seed_region` with (a0, r0, d0); every other
    region starts fully susceptible at population / R."""
    theta = theta.to(torch.float32)
    if not model.is_regional:
        pc = tuple(theta[..., k] for k in range(model.n_params))
        rows = model.initial_rows(
            pc,
            _f32(cfg.population, theta),
            _f32(cfg.a0, theta),
            _f32(cfg.r0, theta),
            _f32(cfg.d0, theta),
        )
        return torch.stack(list(rows), dim=-1).to(torch.float32)
    batch = theta.shape[:-1]
    pc = tuple(theta[..., k:k + 1] for k in range(model.n_params))
    rows = model.initial_rows(
        pc,
        region_population(model, cfg.population, theta),
        seed_vector(model, cfg.a0, theta),
        seed_vector(model, cfg.r0, theta),
        seed_vector(model, cfg.d0, theta),
    )
    rows = [torch.broadcast_to(r, batch + (model.n_regions,)) for r in rows]
    # [..., R, C] -> region-major [..., R*C]
    return torch.stack(rows, dim=-1).reshape(batch + (model.total_state,)).to(torch.float32)


def effective_param_rows(
    model: CompartmentalModel,
    shape: Optional[ScheduleShape],
    pc: Sequence,
    day: int,
    breakpoints: Sequence[int],
):
    """The n_params day-effective rows from the widened rows `pc` (n_params
    base rows, then window-major scale rows). Window 0 is the base rows
    untouched; window w >= 1 multiplies each scaled parameter by its scale
    row, one rounding, as `repro.epi.engine.effective_param_rows` and the
    CUDA kernel do. `day` is a Python int: the port runs its days in a
    Python loop (the plain version) or in the kernel.

    `breakpoints` is a sequence of ints, or an integer tensor [..., n_windows]
    of days a sample; a tensor picks each row's window by `where` and
    multiplies the base rows by 1.0 in window 0, which leaves them bitwise
    as they are."""
    base = tuple(pc[: model.n_params])
    if shape is None or shape.n_windows == 0:
        return base
    if isinstance(breakpoints, torch.Tensor):
        w = (day >= breakpoints).sum(dim=-1)  # each row's window
        out = list(base)
        for j, pi in enumerate(shape.tv_indices):
            scale = torch.ones_like(out[pi])
            for win in range(shape.n_windows):
                scale = torch.where(w == win + 1, pc[model.n_params + win * shape.n_tv + j],
                                    scale)
            out[pi] = out[pi] * scale
        return tuple(out)
    w = sum(day >= b for b in breakpoints)  # #{breakpoints <= day}
    if w == 0:
        return base
    out = list(base)
    first = model.n_params + (w - 1) * shape.n_tv
    for j, pi in enumerate(shape.tv_indices):
        out[pi] = out[pi] * pc[first + j]
    return tuple(out)


def effective_theta(
    model: CompartmentalModel,
    schedule: Optional[InterventionSchedule],
    theta: torch.Tensor,
    day: int,
    breakpoints=None,
) -> torch.Tensor:
    """Widened theta [..., n_params + n_scales] -> day-effective theta
    [..., n_params]. `breakpoints` overrides the schedule's days (ints, or a
    tensor [..., n_windows] of days a sample), as `repro`'s does."""
    schedule = active_schedule(schedule)
    if schedule is None:
        return theta[..., : model.n_params]
    pc = tuple(theta[..., k] for k in range(schedule.param_width(model)))
    bp = schedule.breakpoints if breakpoints is None else breakpoints
    rows = effective_param_rows(model, schedule.shape(model), pc, day, bp)
    return torch.stack(list(rows), dim=-1)


def check_theta_width(model: CompartmentalModel, schedule, theta: torch.Tensor) -> None:
    """Raise unless theta is [B, n_params + n_scales] for the schedule."""
    schedule = active_schedule(schedule)
    width = model.n_params if schedule is None else schedule.param_width(model)
    if theta.ndim != 2 or theta.shape[1] != width:
        what = "" if schedule is None else f" under a schedule of {schedule.n_scales} scales"
        raise ValueError(f"theta must be [B, {width}] for {model.name}{what}, got "
                         f"{tuple(theta.shape)}")


def coupled_rows(model: CompartmentalModel, st: torch.Tensor, mob: torch.Tensor,
                 pop_r=None):
    """The coupled rows of region-major state rows `st` [..., R, C]: for
    each coupled input x (the coupled compartment j, or the j-th row of
    the spec's `coupled_inputs` of the state and the region populations
    `pop_r`), [..., R] with row r = mob[r][0] * x_0 + mob[r][1] * x_1 + ...,
    left to right from the first product."""
    if model.coupled_inputs is None:
        inputs = tuple(st[..., j] for j in model.coupled_idx)
    else:
        inputs = model.coupled_inputs(tuple(st[..., k] for k in range(model.n_state)), pop_r)
    out = []
    for x in inputs:
        row = mob[:, 0] * x[..., 0:1]
        for q in range(1, model.n_regions):
            row = row + mob[:, q] * x[..., q:q + 1]
        out.append(row)
    return tuple(out)


def region_constants(model: CompartmentalModel, mob: torch.Tensor, pop_r) -> tuple:
    """The spec's `region_constants` rows of the float32 matrix and the
    region populations, () without the hook."""
    if model.region_constants is None:
        return ()
    return tuple(model.region_constants(mob, pop_r))


def hazards(
    model: CompartmentalModel,
    state: torch.Tensor,
    theta: torch.Tensor,
    population,
    mobility=None,
) -> torch.Tensor:
    """Transition rates: state [..., total_state] -> h [..., total_transitions]
    >= 0, region-major (slot r * n_transitions + k). `mobility` overrides the
    spec's matrix."""
    if not model.is_regional:
        sc = tuple(state[..., k] for k in range(model.n_state))
        pc = tuple(theta[..., k] for k in range(model.n_params))
        rows = model.hazard_rows(sc, pc, _f32(population, state))
        # hazards are rates of counting processes; they cannot be negative
        return torch.clamp_min(torch.stack(list(rows), dim=-1), 0.0)
    R, C = model.n_regions, model.n_state
    batch = state.shape[:-1]
    st = state.reshape(batch + (R, C))
    sc = tuple(st[..., k] for k in range(C))  # each [..., R]
    pc = tuple(theta[..., k:k + 1] for k in range(model.n_params))
    mob = mobility_matrix(model, mobility, state.device)
    pop_r = region_population(model, population, state)
    rows = model.hazard_rows(
        sc + coupled_rows(model, st, mob, pop_r) + region_constants(model, mob, pop_r),
        pc, pop_r)
    h = torch.stack([torch.broadcast_to(r, batch + (R,)) for r in rows], dim=-1)
    return torch.clamp_min(h, 0.0).reshape(batch + (model.total_transitions,))


def drain_and_apply(model: CompartmentalModel, sc, raw_counts):
    """Clamp raw transition-count rows and apply the stoichiometry.

    Each clamp is bounded by what its source compartment still has after
    earlier transitions out of the same source; an inflow (no source) is
    clamped at zero alone. Returns the next-state rows.
    """
    sc = list(sc)
    remaining = {}  # source compartment -> undrained budget
    counts = []
    for k, src in enumerate(model.transition_sources):
        if src is None:
            counts.append(torch.clamp_min(raw_counts[k], 0.0))
            continue
        avail = remaining.get(src, sc[src])
        n_k = torch.clamp(raw_counts[k], min=torch.zeros_like(avail), max=avail)
        remaining[src] = avail - n_k
        counts.append(n_k)
    for k, row in enumerate(model.stoichiometry):
        for j, coef in enumerate(row):
            if coef == 1:
                sc[j] = sc[j] + counts[k]
            elif coef == -1:
                sc[j] = sc[j] - counts[k]
    return sc


def apply_transitions(
    model: CompartmentalModel, state: torch.Tensor, n_raw: torch.Tensor
) -> torch.Tensor:
    """Tensor-layout wrapper around `drain_and_apply`; a regional spec
    drains each region on rows [..., R]."""
    if not model.is_regional:
        sc = [state[..., k] for k in range(model.n_state)]
        raw = [n_raw[..., k] for k in range(model.n_transitions)]
        return torch.stack(drain_and_apply(model, sc, raw), dim=-1)
    R, C, T = model.n_regions, model.n_state, model.n_transitions
    batch = state.shape[:-1]
    st = state.reshape(batch + (R, C))
    nr = n_raw.reshape(batch + (R, T))
    out = drain_and_apply(model, [st[..., k] for k in range(C)],
                          [nr[..., k] for k in range(T)])
    return torch.stack(out, dim=-1).reshape(batch + (model.total_state,))


def tau_leap_step(
    model: CompartmentalModel,
    state: torch.Tensor,
    theta: torch.Tensor,
    noise: torch.Tensor,
    population,
    mobility=None,
) -> torch.Tensor:
    """One day: n_k = floor(h_k + sqrt(h_k) * z_k), clamped to sources;
    noise is [..., total_transitions], region-major."""
    h = hazards(model, state, theta, population, mobility)
    n_raw = torch.floor(h + torch.sqrt(h) * noise)
    return apply_transitions(model, state, n_raw)


def simulate_observed(
    model: CompartmentalModel,
    theta: torch.Tensor,
    seed: int,
    cfg: EpiModelConfig,
    schedule: Optional[InterventionSchedule] = None,
    mobility=None,
    breakpoints=None,
    sample_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Observed channels [B, total_observed, T] under the counter-hash RNG,
    region-major for a regional spec (channel r * n_observed + m).

    Sample b's noise on day d, slot s is `normal(seed, b, d * ctr_slots +
    s)`, the fused kernel's stream, so the kernel run at the generating
    theta and seed replays this trajectory. Under a schedule theta carries
    the scale columns; the seeding uses the base parameters only.

    Run-time values, each a scalar or a tensor with one row a sample: `seed`
    (masked to 32 bits as an int seed is), `cfg`'s population, a0, r0 and
    d0 (float32, as the kernel reads them), and `breakpoints`, an override of
    the schedule's days ([n_windows] or [B, n_windows]). `sample_index` [B]
    replaces b in the stream (default 0 .. B-1), so that rows stacked from
    several queries keep the indices each would have alone.
    """
    theta = theta.to(torch.float32)
    check_theta_width(model, schedule, theta)
    if sample_index is None:
        idx = krng.sample_indices(theta.shape[0], theta.device)
    else:
        idx = sample_index.to(device=theta.device, dtype=torch.int64)
    if isinstance(seed, torch.Tensor) and seed.ndim:
        seed = krng.as_u32(seed, theta.device).reshape(-1, 1)  # a seed a row
    if isinstance(breakpoints, torch.Tensor):
        breakpoints = breakpoints.to(theta.device)
    state = initial_state(model, theta, cfg)
    pop = _f32(cfg.population, theta)
    mob = mobility_matrix(model, mobility, theta.device) if model.is_regional else None
    obs_idx = _index(tuple(model.total_observed_idx), theta.device)
    obs = []
    for day in range(cfg.num_days):
        z = krng.hash_normals(seed, idx, day, model.total_transitions, model.ctr_slots)
        th_d = effective_theta(model, schedule, theta, day, breakpoints)
        state = tau_leap_step(model, state, th_d, z, pop, mob)
        obs.append(state[:, obs_idx])
    return torch.stack(obs, dim=-1)


def simulate_features(
    model: CompartmentalModel,
    theta: torch.Tensor,
    seed: int,
    cfg: EpiModelConfig,
    schedule: Optional[InterventionSchedule] = None,
    breakpoints=None,
    summary=None,
    mobility=None,
) -> torch.Tensor:
    """Simulate + summary features: theta [B, p] -> [B, n_features].

    The training-pair generator of the NPE backend (`core/npe.py`): the
    summary values of `simulate_observed(theta)` on its flush-day columns
    (`core.summaries.summary_features`), the values the ABC running
    accumulator compares. The noise is `simulate_observed`'s counter-hash
    stream, so a batch is the same for the same seed on every device.
    """
    from repro_torch.core.summaries import get_summary, summary_features

    sim = simulate_observed(model, theta, seed, cfg, schedule, mobility, breakpoints)
    return summary_features(get_summary(summary), sim, model.n_regions)


def regional_view(series: torch.Tensor, model: CompartmentalModel) -> torch.Tensor:
    """Unflatten the region-major channel axis: [..., R*n, T] -> [..., R, n, T]."""
    R = model.n_regions
    n = series.shape[-2] // R
    return series.reshape(series.shape[:-2] + (R, n) + series.shape[-1:])
