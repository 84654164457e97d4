"""Plain PyTorch version of the fused ABC simulation kernel.

Counterpart of `repro.kernels.ref.abc_sim_distance_ref`: simulate T days
with the counter-hash RNG and the running summary accumulator, and return
one distance per sample. The channel terms are added one channel at a time,
in channel order, as in the TPU kernel body (`repro/kernels/abc_sim.py`,
lines 302-314) and in the CUDA kernel (`csrc/abc_sim.cu`).

`repro_torch.kernels.ops.abc_sim_distance` sends a CPU tensor here; the card
runs the CUDA kernel, and `chip_smoke.py` holds the two against each other
on the card. `CALLS` counts the calls, so a run can show that its main path
never came here.
"""

from __future__ import annotations

import torch

from repro_torch.core.summaries import (
    get_distance_kind,
    get_summary,
    lower_summary,
    running_day,
    running_finalize,
)
from repro_torch.epi import engine
from repro_torch.epi.spec import CTR_SLOTS, CompartmentalModel, EpiModelConfig
from repro_torch.kernels import rng as krng

#: number of calls to `abc_sim_distance_ref`
CALLS = 0


def abc_sim_distance_ref(
    theta: torch.Tensor,  # [B, n_params] f32
    seed: int,  # uint32
    observed: torch.Tensor,  # [n_observed, T] f32, on theta's device
    *,
    population: float,
    a0: float,
    r0: float,
    d0: float,
    model: CompartmentalModel | None = None,
    summary=None,
    distance: str = "euclidean",
) -> torch.Tensor:
    """Distances [B] on theta's device."""
    global CALLS
    CALLS += 1
    if model is None:
        from repro_torch.epi.models import DEFAULT_MODEL as model  # noqa: N811
    spec = get_summary(summary)
    kind = get_distance_kind(distance)
    theta = theta.to(torch.float32)
    observed = observed.to(device=theta.device, dtype=torch.float32)
    lowered = lower_summary(spec, distance, observed)
    num_days = observed.shape[1]
    cfg = EpiModelConfig(population=population, num_days=num_days,
                         a0=a0, r0=r0, d0=d0)
    idx = torch.arange(theta.shape[0], device=theta.device)
    pop = torch.tensor(population, dtype=torch.float32, device=theta.device)
    state = engine.initial_state(model, theta, cfg)
    obs_idx = list(model.observed_idx)
    cum = torch.zeros_like(state[:, obs_idx])
    binv = torch.zeros_like(cum)
    acc = torch.zeros_like(state[:, 0])
    for day in range(num_days):
        z = krng.hash_normals(seed, idx, day, model.n_transitions, CTR_SLOTS)
        state = engine.tau_leap_step(model, state, theta, z, pop)
        cum, binv, acc = running_day(
            spec, kind, lowered.weights, state[:, obs_idx],
            lowered.obs_summary[:, day], lowered.flush[day], cum, binv, acc,
        )
    return running_finalize(kind, lowered.mean_scale, acc)
