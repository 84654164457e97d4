"""The stochastic COVID-19 compartmental model of the paper (§2.1): the
facade for its 6-compartment SIARD model (port of `repro.epi.model`).

The spec lives in `repro_torch.epi.models.siard` and the dynamics in the
generic tau-leap engine (`repro_torch.epi.engine`); every function here
binds that engine to the paper spec, under `repro`'s names and constants.

Numerical notes, as `repro`'s: the noise has std sqrt(h), the Poisson's;
transition counts are clamped to [0, available source], draining sources
in order (A->R before A->D, I->A before I->Ru); everything is float32.

Where `repro` takes a threefry `key`, the port takes the counter-hash seed
(`kernels/rng.py`): sample b's noise on day d is the fused kernel's stream,
so the CUDA kernel at the same theta and seed replays these trajectories.
The two packages' noise is not the same draw.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from repro_torch.epi import engine
from repro_torch.epi.models.siard import MODEL as PAPER_MODEL
from repro_torch.epi.models.siard import behavioural_infection_rate
from repro_torch.epi.spec import EpiModelConfig  # noqa: F401  (re-export)
from repro_torch.kernels import rng as krng

N_PARAMS = PAPER_MODEL.n_params
N_STATE = PAPER_MODEL.n_state
N_TRANSITIONS = PAPER_MODEL.n_transitions
N_OBSERVED = PAPER_MODEL.n_observed  # (A, R, D) — indices 2, 3, 4

PARAM_NAMES = PAPER_MODEL.param_names
STATE_NAMES = PAPER_MODEL.compartments

#: Uniform-prior upper bounds, eq. (2) of the paper.
PRIOR_HIGHS = PAPER_MODEL.prior_highs

OBSERVED_IDX = PAPER_MODEL.observed_idx


def infection_rate(theta: torch.Tensor, ard_sum: torch.Tensor) -> torch.Tensor:
    """Eq. (4) over stacked theta [..., 8]; broadcastable batch shapes."""
    return behavioural_infection_rate(theta[..., 0], theta[..., 1], theta[..., 2], ard_sum)


def hazards(state: torch.Tensor, theta: torch.Tensor, population) -> torch.Tensor:
    """Hazard vector h, eq. (5). state: [..., 6], theta: [..., 8] -> [..., 5]."""
    return engine.hazards(PAPER_MODEL, state, theta, population)


def initial_state(theta: torch.Tensor, cfg: EpiModelConfig) -> torch.Tensor:
    """Paper step 1: Ru = 0, I0 = kappa * A0, S = P - (A0 + R0 + D0 + I0)."""
    return engine.initial_state(PAPER_MODEL, theta, cfg)


def tau_leap_step(state: torch.Tensor, theta: torch.Tensor, noise: torch.Tensor,
                  population) -> torch.Tensor:
    """One day of tau-leaping given standard-normal noise [..., 5]."""
    return engine.tau_leap_step(PAPER_MODEL, state, theta, noise, population)


def _days(theta: torch.Tensor, seed: int, cfg: EpiModelConfig) -> Iterator[torch.Tensor]:
    """The state [B, 6] after each day, on `engine.simulate_observed`'s noise."""
    theta = theta.to(torch.float32)
    idx = torch.arange(theta.shape[0], device=theta.device)
    state = initial_state(theta, cfg)
    pop = engine._f32(cfg.population, theta)
    for day in range(cfg.num_days):
        z = krng.hash_normals(seed, idx, day, N_TRANSITIONS, PAPER_MODEL.ctr_slots)
        state = engine.tau_leap_step(PAPER_MODEL, state, theta, z, pop)
        yield state


def simulate(theta: torch.Tensor, seed: int, cfg: EpiModelConfig) -> torch.Tensor:
    """Simulate the full state trajectory. theta: [B, 8] -> [B, T, 6]."""
    return torch.stack(list(_days(theta, seed, cfg)), dim=1)


def simulate_observed(theta: torch.Tensor, seed: int, cfg: EpiModelConfig) -> torch.Tensor:
    """Simulate only the observed channels. Returns [B, 3, T] = (A, R, D)."""
    return engine.simulate_observed(PAPER_MODEL, theta, seed, cfg)


def simulate_observed_lowmem(theta: torch.Tensor, seed: int, cfg: EpiModelConfig,
                             observed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused simulate + running Euclidean distance, never holding [B, 3, T]:
    (distance [B], final state [B, 6]), the distance channel by channel as
    the fused kernel sums it (`core.summaries.running_day`)."""
    from repro_torch.core.summaries import (
        get_distance_kind,
        get_summary,
        lower_summary,
        running_day,
        running_finalize,
    )

    spec, kind = get_summary(None), get_distance_kind("euclidean")
    observed = observed.to(device=theta.device, dtype=torch.float32)
    lowered = lower_summary(spec, "euclidean", observed)
    obs_idx = list(OBSERVED_IDX)
    cum = torch.zeros((theta.shape[0], N_OBSERVED), device=theta.device)
    binv = torch.zeros_like(cum)
    acc = torch.zeros((theta.shape[0],), device=theta.device)
    state = None
    for day, state in enumerate(_days(theta, seed, cfg)):
        cum, binv, acc = running_day(spec, kind, lowered.weights, state[:, obs_idx],
                                     lowered.obs_summary[:, day], lowered.flush[day], cum,
                                     binv, acc)
    return running_finalize(kind, lowered.mean_scale, acc), state
