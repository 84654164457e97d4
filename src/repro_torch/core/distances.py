"""Batched distance functions between simulated and observed data (port of
`repro.core.distances`).

The paper uses the Euclidean distance over the flattened observed channels
— [3, T] = (A, R, D) for its SIARD model; every function here is generic
over the channel count, so the shapes below are [B, C, T] with C the
model's n_observed. The normalized variant is the ablation's. The fused
kernel computes these distances in its running accumulator
(`core.summaries`); these are the whole-series forms.
"""

from __future__ import annotations

import torch


def euclidean_distance(simulated: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """dist(D_s, D) = ||D_s - D||_2 over the trailing [C, T] axes.

    simulated: [B, C, T]; observed: [C, T]  ->  [B].
    """
    diff = simulated - observed[None]
    return torch.sqrt(torch.sum(diff * diff, dim=(-2, -1)))


def mean_absolute_distance(simulated: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over channels x days. [B, C, T], [C, T] -> [B]."""
    return torch.mean(torch.abs(simulated - observed[None]), dim=(-2, -1))


def normalized_euclidean_distance(simulated: torch.Tensor, observed: torch.Tensor,
                                  eps: float = 1.0) -> torch.Tensor:
    """Euclidean distance with each channel divided by its observed scale
    (root mean square over the days, plus `eps`), so that tolerances compare
    across countries of very different case counts."""
    scale = torch.sqrt(torch.mean(observed * observed, dim=-1, keepdim=True)) + eps
    diff = (simulated - observed[None]) / scale[None]
    return torch.sqrt(torch.sum(diff * diff, dim=(-2, -1)))


DISTANCES = {
    "euclidean": euclidean_distance,
    "mae": mean_absolute_distance,
    "normalized_euclidean": normalized_euclidean_distance,
}
