"""Uniform box priors drawn from the counter-hash stream (port).

`UniformBoxPrior.sample(seed, batch, device)` maps `uniform_open(seed, b, j)`
(sample b, dimension j) into the box: theta = low + u * (high - low); at
`offset=o` sample b draws on index o + b, so its rows are rows [o, o + batch)
of the draw of o + batch at offset 0 (the kernels' wave entries). The
integer bits and the three float32 operations are exact on every device, so
the same seed gives the same theta on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import rng as krng

#: calls of `UniformBoxPrior.sample` on a CUDA device
DEVICE_DRAWS = 0


@dataclasses.dataclass(frozen=True)
class UniformBoxPrior:
    """U(lows, highs) over R^p, independent per dimension."""

    highs: tuple
    lows: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "highs", tuple(float(h) for h in self.highs))
        lows = self.lows or tuple(0.0 for _ in self.highs)
        object.__setattr__(self, "lows", tuple(float(l) for l in lows))
        if len(self.lows) != len(self.highs):
            raise ValueError("lows and highs must have the same length")

    @property
    def dim(self) -> int:
        return len(self.highs)

    def _bounds(self, device):
        """(lows, highs) as float32 tensors on `device`, copied there once a
        box and device (callers do not write to them)."""
        device = torch.device(device)
        return _box_tensor(self.lows, device), _box_tensor(self.highs, device)

    def sample(self, seed: int, batch: int, device="cpu", offset: int = 0) -> torch.Tensor:
        """[batch, dim] float32 draws for uint32 `seed`, on `device`, of the
        samples at indices offset .. offset + batch - 1."""
        global DEVICE_DRAWS
        device = torch.device(device)
        if device.type == "cuda":
            DEVICE_DRAWS += 1
        lo, hi = self._bounds(device)
        idx = krng.sample_indices(batch, device, offset)[:, None]
        ctr = torch.arange(self.dim, device=device)[None, :]
        u = krng.uniform_open(seed, idx, ctr)
        return lo + u * (hi - lo)

    def log_pdf(self, theta: torch.Tensor) -> torch.Tensor:
        """log p(theta) per sample; -inf outside the box. Zero-width
        dimensions are point masses and add nothing to the volume."""
        lo, hi = self._bounds(theta.device)
        inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
        width = hi - lo
        log_vol = torch.sum(
            torch.where(width > 0, torch.log(torch.clamp_min(width, 1e-38)),
                        torch.zeros_like(width))
        )
        return torch.where(inside, -log_vol, torch.full_like(log_vol, -float("inf")))

    def free_dims(self) -> tuple:
        """True per dimension where the box has positive width; False marks
        a pinned value (a zero-width dimension, e.g. a fixed scale)."""
        return tuple(h > lo for lo, h in zip(self.lows, self.highs))

    def clip(self, theta: torch.Tensor) -> torch.Tensor:
        lo, hi = self._bounds(theta.device)
        return torch.clamp(theta, lo, hi)


@functools.lru_cache(maxsize=256)
def _box_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def schedule_prior(model, schedule=None) -> UniformBoxPrior:
    """The model's box widened by a schedule's window-major scale bounds; a
    pinned scale is a zero-width dimension. With no schedule (or an empty
    one) it is `model.prior()`."""
    base = model.prior()
    if schedule is None or schedule.is_empty:
        return base
    return UniformBoxPrior(
        highs=base.highs + tuple(h for row in schedule.scale_highs for h in row),
        lows=base.lows + tuple(lo for row in schedule.scale_lows for lo in row),
    )


def paper_prior() -> UniformBoxPrior:
    """The prior of eq. (2): U(0, [1, 100, 2, 1, 1, 1, 1, 2])."""
    return UniformBoxPrior(highs=(1.0, 100.0, 2.0, 1.0, 1.0, 1.0, 1.0, 2.0))
