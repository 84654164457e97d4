"""Generic tau-leap engine over a `CompartmentalModel` spec (port, flat).

The port's counterpart of `repro.epi.engine` for flat (R=1) models, with
intervention schedules (`effective_param_rows`). Functions take tensors on
any device and keep them there; every scalar that meets a tensor becomes a
float32 tensor on that tensor's device first (`_f32`), so that a division
by the population rounds the same way on the CPU and on the card.

`drain_and_apply` stays row-level: it is the mass-conservation contract.
Transitions are clamped in declaration order with sequential source
draining, so no compartment goes negative and the total is conserved.

`simulate_observed` draws its noise from the counter-hash RNG
(`repro_torch.kernels.rng`), the same stream as the fused kernel; the JAX
package's threefry streams have no PyTorch twin.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.epi.spec import (
    CTR_SLOTS,
    CompartmentalModel,
    EpiModelConfig,
    InterventionSchedule,
    ScheduleShape,
    active_schedule,
)
from repro_torch.kernels import rng as krng


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float or tensor as a float32 tensor on `like`'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def initial_state(
    model: CompartmentalModel, theta: torch.Tensor, cfg: EpiModelConfig
) -> torch.Tensor:
    """Spec step 1: theta [..., n_params] -> state [..., n_state]."""
    theta = theta.to(torch.float32)
    pc = tuple(theta[..., k] for k in range(model.n_params))
    rows = model.initial_rows(
        pc,
        _f32(cfg.population, theta),
        _f32(cfg.a0, theta),
        _f32(cfg.r0, theta),
        _f32(cfg.d0, theta),
    )
    return torch.stack(list(rows), dim=-1).to(torch.float32)


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
    Python loop (the plain version) or in the kernel."""
    base = tuple(pc[: model.n_params])
    if shape is None or shape.n_windows == 0:
        return base
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
) -> torch.Tensor:
    """Widened theta [..., n_params + n_scales] -> day-effective theta
    [..., n_params]."""
    schedule = active_schedule(schedule)
    if schedule is None:
        return theta[..., : model.n_params]
    pc = tuple(theta[..., k] for k in range(schedule.param_width(model)))
    rows = effective_param_rows(model, schedule.shape(model), pc, day, schedule.breakpoints)
    return torch.stack(list(rows), dim=-1)


def check_theta_width(model: CompartmentalModel, schedule, theta: torch.Tensor) -> None:
    """Raise unless theta is [B, n_params + n_scales] for the schedule."""
    schedule = active_schedule(schedule)
    width = model.n_params if schedule is None else schedule.param_width(model)
    if theta.ndim != 2 or theta.shape[1] != width:
        what = "" if schedule is None else f" under a schedule of {schedule.n_scales} scales"
        raise ValueError(f"theta must be [B, {width}] for {model.name}{what}, got "
                         f"{tuple(theta.shape)}")


def hazards(
    model: CompartmentalModel,
    state: torch.Tensor,
    theta: torch.Tensor,
    population,
) -> torch.Tensor:
    """Transition rates: state [..., n_state] -> h [..., n_transitions] >= 0."""
    sc = tuple(state[..., k] for k in range(model.n_state))
    pc = tuple(theta[..., k] for k in range(model.n_params))
    rows = model.hazard_rows(sc, pc, _f32(population, state))
    # hazards are rates of counting processes; they cannot be negative
    return torch.clamp_min(torch.stack(list(rows), dim=-1), 0.0)


def drain_and_apply(model: CompartmentalModel, sc, raw_counts):
    """Clamp raw transition-count rows and apply the stoichiometry.

    Each clamp is bounded by what its source compartment still has after
    earlier transitions out of the same source. Returns the next-state rows.
    """
    sc = list(sc)
    remaining = {}  # source compartment -> undrained budget
    counts = []
    for k, src in enumerate(model.transition_sources):
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
    """Tensor-layout wrapper around `drain_and_apply`."""
    sc = [state[..., k] for k in range(model.n_state)]
    raw = [n_raw[..., k] for k in range(model.n_transitions)]
    return torch.stack(drain_and_apply(model, sc, raw), dim=-1)


def tau_leap_step(
    model: CompartmentalModel,
    state: torch.Tensor,
    theta: torch.Tensor,
    noise: torch.Tensor,
    population,
) -> torch.Tensor:
    """One day: n_k = floor(h_k + sqrt(h_k) * z_k), clamped to sources."""
    h = hazards(model, state, theta, population)
    n_raw = torch.floor(h + torch.sqrt(h) * noise)
    return apply_transitions(model, state, n_raw)


def simulate_observed(
    model: CompartmentalModel,
    theta: torch.Tensor,
    seed: int,
    cfg: EpiModelConfig,
    schedule: Optional[InterventionSchedule] = None,
) -> torch.Tensor:
    """Observed channels [B, n_observed, T] under the counter-hash RNG.

    Sample b's noise on day d, transition k is `normal(seed, b, d*8 + k)`,
    the fused kernel's stream, so the kernel run at the generating theta and
    seed replays this trajectory. Under a schedule theta carries the scale
    columns; the seeding uses the base parameters only.
    """
    theta = theta.to(torch.float32)
    check_theta_width(model, schedule, theta)
    idx = torch.arange(theta.shape[0], device=theta.device)
    state = initial_state(model, theta, cfg)
    pop = _f32(cfg.population, theta)
    obs = []
    for day in range(cfg.num_days):
        z = krng.hash_normals(seed, idx, day, model.n_transitions, CTR_SLOTS)
        th_d = effective_theta(model, schedule, theta, day)
        state = tau_leap_step(model, state, th_d, z, pop)
        obs.append(state[:, list(model.observed_idx)])
    return torch.stack(obs, dim=-1)
