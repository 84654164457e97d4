"""Summary statistics and distance kinds (port).

The port's copy of `repro.core.summaries`. Every (summary, distance) pair
reduces to one running accumulator. Per day t, with
per-channel carries `cum` and `bin`:

    cum  += x_t
    v     = cum if cumulative else x_t
    bin   = v if cumulative else bin + v
    flush = ((t+1) % bin_days == 0) or (t == T-1)
    s     = log1p(max(bin, 0)) if log1p else bin
    acc  += flush * w_c * |s_c - obs_summary_c[t]| ** power    (channel by channel)
    bin  *= 1 - flush
    dist  = sqrt(acc * mean_scale) | acc * mean_scale           by distance kind

The observed side is lowered once (`lower_summary`) into the same running
layout. The CUDA kernel reads the lowered selectors, weights and mean scale
as runtime values, so one build serves every pair.

A regional series has its channels region-major ([R * n_obs, T]); its
per-region channel weights tile across the regions. `region_pooled` sums
each observed compartment over the regions before the transform
(`pool_channels`), x_r0 + x_r1 + ... left to right as the TPU kernel body
sums it, and compares national aggregates; at R=1 it is the identity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SummarySpec:
    """A composable summary transform: cumulative -> binning -> log1p."""

    name: str = "identity"
    cumulative: bool = False
    log1p: bool = False
    #: bin length in days; 1 = daily. The final bin may be partial.
    bin_days: int = 1
    #: optional per-channel weights (length n_observed); None = all 1.0.
    #: For a regional model either the region-major total or one weight a
    #: compartment, tiled over the regions.
    channel_weights: Optional[Tuple[float, ...]] = None
    #: regional models only: sum each observed compartment over the regions
    #: before the transform; a no-op at R=1
    region_pool: bool = False

    def __post_init__(self):
        if self.bin_days < 1:
            raise ValueError(f"bin_days must be >= 1, got {self.bin_days}")
        if self.channel_weights is not None:
            object.__setattr__(
                self, "channel_weights",
                tuple(float(w) for w in self.channel_weights),
            )
            if any(w < 0 for w in self.channel_weights):
                raise ValueError("channel weights must be non-negative")

    @property
    def is_identity(self) -> bool:
        """True when the transform is a no-op (the paper's raw statistic)."""
        return (not self.cumulative and not self.log1p and self.bin_days == 1
                and self.channel_weights is None and not self.region_pool)

    def tag(self) -> str:
        """Filesystem-safe label for campaign scenario names, `repro`'s
        letter for letter: the bare name only for the registered spec of
        that name, else a label made from the parameters, so two different
        statistics never share a name (and a checkpoint directory)."""
        if SUMMARIES.get(self.name) == self:
            return self.name
        if self.is_identity:
            return "identity"
        parts = []
        if self.cumulative:
            parts.append("cum")
        if self.bin_days > 1:
            parts.append(f"bin{self.bin_days}")
        if self.log1p:
            parts.append("log1p")
        if self.channel_weights is not None:
            parts.append("w" + "-".join(f"{w:g}" for w in self.channel_weights))
        if self.region_pool:
            parts.append("rpool")
        return "_".join(parts)


#: named summaries
SUMMARIES = {
    "identity": SummarySpec(),
    "weekly": SummarySpec("weekly", bin_days=7),
    "cumulative": SummarySpec("cumulative", cumulative=True),
    "log_daily": SummarySpec("log_daily", log1p=True),
    "log_weekly": SummarySpec("log_weekly", bin_days=7, log1p=True),
    # national aggregates of a regional model; the identity at R=1
    "region_pooled": SummarySpec("region_pooled", region_pool=True),
}


def list_summaries() -> Tuple[str, ...]:
    return tuple(sorted(SUMMARIES))


def get_summary(s) -> SummarySpec:
    """Resolve None (identity) / registry name / SummarySpec instance."""
    if s is None:
        return SUMMARIES["identity"]
    if isinstance(s, SummarySpec):
        return s
    if isinstance(s, str):
        try:
            return SUMMARIES[s]
        except KeyError:
            raise ValueError(
                f"unknown summary {s!r}; registered: {list_summaries()}"
            ) from None
    raise TypeError(f"summary must be None, a name or a SummarySpec; got {s!r}")


class DistanceKind(NamedTuple):
    """How the weighted per-term residuals reduce to one distance."""

    power: int  # 1 (absolute) | 2 (squared) residuals
    root: bool  # sqrt the accumulator at the end (L2 family)
    mean: bool  # divide by the number of summary terms (mean-L1 family)
    normalize: bool  # fold 1/observed-scale^2 into the channel weights


DISTANCE_KINDS = {
    "euclidean": DistanceKind(power=2, root=True, mean=False, normalize=False),
    "mae": DistanceKind(power=1, root=False, mean=True, normalize=False),
    "normalized_euclidean": DistanceKind(
        power=2, root=True, mean=False, normalize=True
    ),
}


def get_distance_kind(name: str) -> DistanceKind:
    try:
        return DISTANCE_KINDS[name]
    except KeyError:
        raise ValueError(
            f"unknown distance {name!r}; registered: {tuple(sorted(DISTANCE_KINDS))}"
        ) from None


def summary_pairs() -> Tuple[Tuple[str, str], ...]:
    """Every registered (summary, distance) combination."""
    return tuple((s, d) for s in list_summaries() for d in sorted(DISTANCE_KINDS))


# indices into LoweredSummary.flags, the int32 selectors the kernel reads
FLAG_CUMULATIVE, FLAG_LOG1P, FLAG_POWER, FLAG_ROOT, FLAG_BIN_DAYS = range(5)


class LoweredSummary(NamedTuple):
    """Runtime values for one (summary, distance) pair against one series."""

    obs_summary: torch.Tensor  # [n_obs, T] f32, running-bin layout
    flush: torch.Tensor  # [T] f32, 1.0 on days whose bin closes
    weights: torch.Tensor  # [n_obs] f32, channel weights incl. normalization
    mean_scale: float  # float32 value: 1/n_terms for mean kinds, else 1.0
    flags: Tuple[int, ...]  # selectors, indexed by FLAG_*


def num_bins(num_days: int, bin_days: int) -> int:
    """Summary terms per channel (the final partial bin counts)."""
    return -(-num_days // bin_days)


def flush_mask(num_days: int, bin_days: int, device=None) -> torch.Tensor:
    """[T] f32: 1.0 on the last day of each bin (incl. a partial final bin)."""
    t = np.arange(num_days)
    m = ((t + 1) % bin_days == 0) | (t == num_days - 1)
    return torch.as_tensor(m.astype(np.float32), device=device)


def pool_factor(spec: SummarySpec, n_regions: int) -> int:
    """The region-pooling factor: `n_regions` when `spec` pools the regions
    of a regional series, else 1."""
    return n_regions if (spec.region_pool and n_regions > 1) else 1


def pool_channels(x: torch.Tensor, pool: int, axis: int = -1) -> torch.Tensor:
    """Sum a region-major channel axis (length pool * n) over the regions:
    x_r0 + x_r1 + ..., left to right, one operation a region. `pool` <= 1
    returns `x` as it is."""
    if pool <= 1:
        return x
    axis = axis % x.ndim
    n_chan = x.shape[axis]
    if n_chan % pool:
        raise ValueError(f"cannot pool axis of length {n_chan} by region factor {pool}")
    parts = x.unflatten(axis, (pool, n_chan // pool)).unbind(axis)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


@functools.lru_cache(maxsize=256)
def _bin_starts(num_days: int, bin_days: int, device: torch.device):
    """(the day before each day's bin starts, clamped at 0; whether it has
    one) on `device`, copied there once a shape."""
    t = np.arange(num_days)
    start = (t // bin_days) * bin_days  # first day of t's bin
    return (torch.as_tensor(np.maximum(start - 1, 0), device=device),
            torch.as_tensor(start > 0, device=device))


@functools.lru_cache(maxsize=256)
def _flush_index(num_days: int, bin_days: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(flush_columns(num_days, bin_days), device=device)


def apply_summary(spec: SummarySpec, series: torch.Tensor) -> torch.Tensor:
    """Summary transform in the running-bin layout, [..., n_obs, T]."""
    x = series.to(torch.float32)
    num_days = x.shape[-1]
    v = torch.cumsum(x, dim=-1) if spec.cumulative else x
    if spec.bin_days > 1 and not spec.cumulative:
        cv = torch.cumsum(v, dim=-1)
        prev_idx, has_prev = _bin_starts(num_days, spec.bin_days, x.device)
        prev = torch.where(has_prev, cv[..., prev_idx], torch.zeros_like(cv))
        v = cv - prev  # running within-bin sum at day t
    if spec.log1p:
        v = torch.log1p(torch.clamp_min(v, 0.0))
    return v


def lower_summary(
    spec: SummarySpec, distance: str, observed: torch.Tensor, n_regions: int = 1
) -> LoweredSummary:
    """Lower the observed side and the weights of one pair, on `observed`'s
    device. A regional series ([R * n_obs, T], region-major) passes its
    `n_regions`: a pooling spec sums it over the regions here, and
    per-region channel weights tile region-major."""
    kind = get_distance_kind(distance)
    obs = pool_channels(observed.to(torch.float32), pool_factor(spec, n_regions), axis=-2)
    n_obs, num_days = obs.shape
    s = apply_summary(spec, obs)
    fl = flush_mask(num_days, spec.bin_days, device=obs.device)
    nb = num_bins(num_days, spec.bin_days)
    if spec.channel_weights is not None:
        cw = spec.channel_weights
        if len(cw) != n_obs and n_regions > 1 and len(cw) * n_regions == n_obs:
            cw = cw * n_regions  # per-region weights, tiled region-major
        if len(cw) != n_obs:
            raise ValueError(
                f"summary {spec.name!r} has {len(spec.channel_weights)} channel "
                f"weights for {n_obs} observed channels"
            )
        w = torch.tensor(cw, dtype=torch.float32, device=obs.device)
    else:
        w = torch.ones((n_obs,), dtype=torch.float32, device=obs.device)
    if kind.normalize:
        # per-channel RMS of the observed summary over its flush days
        msq = torch.sum(fl * s * s, dim=-1) / nb
        scale = torch.sqrt(msq) + 1.0
        w = w / (scale * scale)
    mean_scale = float(np.float32(1.0 / (n_obs * nb) if kind.mean else 1.0))
    flags = (int(spec.cumulative), int(spec.log1p), kind.power, int(kind.root),
             spec.bin_days)
    return LoweredSummary(s, fl, w, mean_scale, flags)


def flush_columns(num_days: int, bin_days: int) -> np.ndarray:
    """Day indices of the flush (bin-closing) columns, [n_bins]."""
    t = np.arange(num_days)
    return t[((t + 1) % bin_days == 0) | (t == num_days - 1)]


def summary_features(spec: SummarySpec, series: torch.Tensor,
                     n_regions: int = 1) -> torch.Tensor:
    """A series' summary feature vector, [..., n_obs, T] -> [..., n_chan *
    n_bins]: pooled over the regions, transformed, and its flush-day columns,
    the values the running accumulator compares."""
    x = pool_channels(series.to(torch.float32), pool_factor(spec, n_regions), axis=-2)
    s = apply_summary(spec, x)
    feats = s[..., _flush_index(x.shape[-1], spec.bin_days, x.device)]
    return feats.reshape(feats.shape[:-2] + (-1,))


def running_day(
    spec: SummarySpec,
    kind: DistanceKind,
    weights: torch.Tensor,
    x: torch.Tensor,  # [B, n_obs], this day's observed-channel values
    obs_t: torch.Tensor,  # [n_obs], observed summary at day t
    flush_t: torch.Tensor,  # [] f32, 1.0 if day t closes a bin
    cum: torch.Tensor,  # [B, n_obs] carry
    binv: torch.Tensor,  # [B, n_obs] carry
    acc: torch.Tensor,  # [B] carry
):
    """One day of the running accumulator.

    The channel terms are added to `acc` one channel at a time, in channel
    order, as the fused kernel does; `repro`'s version sums the channels
    first, which rounds differently in the last bit.
    """
    if spec.cumulative:
        cum = cum + x
        binv = cum
    else:
        binv = binv + x
    s = torch.log1p(torch.clamp_min(binv, 0.0)) if spec.log1p else binv
    diff = s - obs_t
    term = torch.abs(diff) if kind.power == 1 else diff * diff
    for m in range(term.shape[-1]):
        acc = acc + flush_t * (weights[m] * term[..., m])
    binv = binv * (1.0 - flush_t)
    return cum, binv, acc


def running_finalize(kind: DistanceKind, mean_scale: float,
                     acc: torch.Tensor) -> torch.Tensor:
    acc = acc * mean_scale
    return torch.sqrt(acc) if kind.root else acc
