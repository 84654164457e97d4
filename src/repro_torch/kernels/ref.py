"""Plain PyTorch versions of the port's kernels.

`abc_sim_distance_ref` is the plain version of the fused ABC simulation
kernel; `flash_attention_ref` that of the flash-attention kernel (below).

Counterpart of `repro.kernels.ref.abc_sim_distance_ref`: simulate T days
with the counter-hash RNG and the running summary accumulator, and return
one distance per sample. The channel terms are added one channel at a time,
in channel order, as in the TPU kernel body (`repro/kernels/abc_sim.py`,
lines 302-314) and in the CUDA kernels (`csrc/abc_sim.cuh`,
`csrc/abc_sim_regional.cuh`).

A regional model follows the TPU kernel body's order, not that of
`repro`'s engine: the coupled rows sum mob[r][q] * x_q over q left to
right from the first product (`engine.coupled_rows`, abc_sim.py:256-259),
a pooled channel sums the regions left to right (`summaries.pool_channels`,
:289-294), the channels run region-major, and a region holds population /
R divided in float32 (:200). Region r's transition k draws slot r *
n_transitions + k of the day's `model.ctr_slots`.

`repro_torch.kernels.ops.abc_sim_distance` sends a CPU tensor here; the card
runs the CUDA kernel, and `chip_smoke.py` holds the two against each other
on the card. `CALLS` counts the calls, so a run can show that its main path
never came here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.summaries import (
    get_distance_kind,
    get_summary,
    lower_summary,
    pool_channels,
    pool_factor,
    running_day,
    running_finalize,
)
from repro_torch.epi import engine
from repro_torch.epi.spec import CompartmentalModel, EpiModelConfig
from repro_torch.kernels import rng as krng

#: number of calls to `abc_sim_distance_ref`
CALLS = 0
#: number of calls to `flash_attention_ref`
FLASH_CALLS = 0
NEG_INF = -1e30


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
    schedule=None,
    mobility=None,
    sample_offset: int = 0,
) -> torch.Tensor:
    """Distances [B] on theta's device. Under an intervention `schedule`
    theta is [B, n_params + n_scales] and each day runs on the day-effective
    parameters (`engine.effective_theta`), as `repro.kernels.ref` does. A
    regional model's `observed` is [R * n_observed, T], region-major;
    `mobility` overrides its matrix. Sample b's noise hashes on
    `sample_offset` + b (`rng.sample_indices`), as in the wave entries."""
    global CALLS
    CALLS += 1
    if model is None:
        from repro_torch.epi.models import DEFAULT_MODEL as model  # noqa: N811
    spec = get_summary(summary)
    kind = get_distance_kind(distance)
    theta = theta.to(torch.float32)
    engine.check_theta_width(model, schedule, theta)
    observed = observed.to(device=theta.device, dtype=torch.float32)
    lowered = lower_summary(spec, distance, observed, n_regions=model.n_regions)
    pool = pool_factor(spec, model.n_regions)
    mob = engine.mobility_matrix(model, mobility, theta.device) if model.is_regional else None
    num_days = observed.shape[1]
    cfg = EpiModelConfig(population=population, num_days=num_days,
                         a0=a0, r0=r0, d0=d0)
    idx = krng.sample_indices(theta.shape[0], theta.device, sample_offset)
    pop = torch.tensor(population, dtype=torch.float32, device=theta.device)
    state = engine.initial_state(model, theta, cfg)
    obs_idx = list(model.total_observed_idx)
    cum = torch.zeros_like(pool_channels(state[:, obs_idx], pool))
    binv = torch.zeros_like(cum)
    acc = torch.zeros_like(state[:, 0])
    for day in range(num_days):
        z = krng.hash_normals(seed, idx, day, model.total_transitions, model.ctr_slots)
        th_d = engine.effective_theta(model, schedule, theta, day)
        state = engine.tau_leap_step(model, state, th_d, z, pop, mob)
        cum, binv, acc = running_day(
            spec, kind, lowered.weights, pool_channels(state[:, obs_idx], pool),
            lowered.obs_summary[:, day], lowered.flush[day], cum, binv, acc,
        )
    return running_finalize(kind, lowered.mean_scale, acc)


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    kv_block: int = 128,
) -> torch.Tensor:
    """Plain version of the flash kernel: o [B, Sq, H, D] in q's dtype.

    Mirrors `repro/kernels/flash_attention.py::_kernel` (and the CUDA
    kernels, `csrc/flash_attention_tf32.cu` for float32 and
    `csrc/flash_attention_wgmma.cu` for bf16): q is cast to float32 and
    scaled, scores are float32 and soft-capped, then masked with NEG_INF by
    padding (key < Skv), causality (key <= query, query i aligned with key
    i) and the window (query - key < window); an online softmax runs over KV
    blocks of `kv_block` keys with float32 (m, l, acc), masked probabilities
    set to 0; the output is acc / max(l, 1e-30), rounded once to q's dtype,
    so a row with no allowed key is 0. GQA reads kv head h // (H // KH).

    The TPU kernel also tiles queries and stops each tile's sweep at its
    causal bound; a skipped block is fully masked and changes neither m, l
    nor acc, so sweeping every block for all queries at once is the same.
    """
    global FLASH_CALLS
    FLASH_CALLS += 1
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    qf = q.to(torch.float32).transpose(1, 2) * float(scale)  # [B, H, Sq, D]
    kf = k.to(torch.float32).repeat_interleave(h // kh, dim=2).transpose(1, 2)
    vf = v.to(torch.float32).repeat_interleave(h // kh, dim=2).transpose(1, 2)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, kv_block):
        s = qf @ kf[:, :, k0:k0 + kv_block].transpose(-1, -2)  # [B, H, Sq, kb]
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, min(k0 + kv_block, skv), device=q.device)[None, :]
        ok = torch.ones((sq, k_pos.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos <= q_pos
        if window is not None:
            ok &= q_pos - k_pos < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vf[:, :, k0:k0 + kv_block]
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
