"""Counter-based RNG, plain PyTorch twin of `repro.kernels.rng`.

A murmur3-finalizer double mix of (seed, sample index, counter) gives one
uint32; its top 24 bits give a uniform on (0, 1]; Box-Muller (cos branch)
turns the uniforms of counters 2c and 2c+1 into one standard normal. The
CUDA kernel inlines the same functions (`csrc/rng.cuh`), so the integer bits
agree exactly between the JAX package, this twin and the card; the floats
agree to the last few ulps of `log` and `cos`.

PyTorch has no dependable uint32 multiply, so the words ride in int64
tensors holding values in [0, 2**32). A product with a 32-bit constant
splits the word into 16-bit halves, so no partial product leaves int64 and
the low 32 bits come out exact (`_mul32`). A seed or counter given as a
Python int stays one (a scalar operand of the tensor operations), so that
hashing on the card copies nothing from the host.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
P1 = 0x9E3779B1  # golden-ratio prime: sample index stream
P2 = 0x85EBCA77  # counter stream
X1 = 0x1B873593  # second-round decorrelation constant

TWO_PI = float(np.float32(2.0 * np.pi))
INV_2_24 = float(np.float32(1.0 / (1 << 24)))


def as_u32(x, device=None) -> torch.Tensor:
    """An int, array or tensor as an int64 tensor of uint32 values."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device or x.device, dtype=torch.int64)
    else:
        # analysis: allow(host-sync-in-wave-loop) — x is a host int or array
        # here (a tensor takes the branch above): nothing is read from a card
        t = torch.as_tensor(np.asarray(x, np.int64), device=device)
    return t & MASK32


def _word(x, device=None):
    """An int as a Python int of 32 bits, anything else as `as_u32` gives it."""
    if isinstance(x, (int, np.integer)):
        # analysis: allow(host-sync-in-wave-loop) — x is a Python or numpy
        # integer here, not a tensor
        return int(x) & MASK32
    return as_u32(x, device)


def _mul32(x, m: int):
    """(x * m) mod 2**32 for x in [0, 2**32) (a tensor or an int) and a
    32-bit constant m."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * m + ((hi * (m & 0xFFFF)) << 16)) & MASK32


def fmix32(x):
    """murmur3 32-bit finalizer (bijective mix)."""
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    x = x ^ (x >> 16)
    return x


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _hash(seed, idx, ctr):
    """h(seed, idx, ctr) of 32-bit words (ints or int64 tensors)."""
    return fmix32(fmix32(seed ^ _mul32(idx, P1) ^ _mul32(ctr, P2) ^ X1))


def hash_u32(seed, idx, ctr) -> torch.Tensor:
    """Counter-based uint32 stream h(seed, sample index, counter), as int64."""
    dev = _device_of(seed, idx, ctr)
    h = _hash(_word(seed, dev), _word(idx, dev), _word(ctr, dev))
    return h if isinstance(h, torch.Tensor) else torch.tensor(h, dtype=torch.int64)


def uniform_open(seed, idx, ctr) -> torch.Tensor:
    """U in (0, 1]: ((h >> 8) + 1) * 2^-24, float32 (log-safe)."""
    h = hash_u32(seed, idx, ctr)
    return ((h >> 8) + 1).to(torch.float32) * INV_2_24


def normal(seed, idx, ctr) -> torch.Tensor:
    """Standard normal via Box-Muller (cos branch), float32.

    Consumes counters (2*ctr, 2*ctr + 1) of the (seed, idx) stream.
    """
    dev = _device_of(seed, idx, ctr)
    ctr = _word(ctr, dev)
    u1 = uniform_open(seed, idx, (ctr * 2) & MASK32)
    u2 = uniform_open(seed, idx, (ctr * 2 + 1) & MASK32)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(TWO_PI * u2)


def day_transition_ctr(day, k, slots: int = 8) -> torch.Tensor:
    """Counter of transition slot `k` on `day`: day * slots + k (uint32). An
    int day stays a Python int (no copy to the device)."""
    dev = _device_of(day, k)
    if isinstance(day, (int, np.integer)) and isinstance(k, torch.Tensor):
        return (as_u32(k, dev) + (int(day) & MASK32) * slots) & MASK32
    return (as_u32(day, dev) * slots + as_u32(k, dev)) & MASK32


def hash_normals(seed, idx: torch.Tensor, day: int, n_transitions: int,
                 slots: int = 8) -> torch.Tensor:
    """Noise block [B, n_transitions] for one day, from the counter stream."""
    ctr = day_transition_ctr(
        day, torch.arange(n_transitions, device=idx.device), slots
    )
    return normal(seed, idx[:, None], ctr[None, :])


#: sample indices are 32-bit words: a launch's indices end at or below this
INDEX_LIMIT = 1 << 32


def check_offset(offset: int, batch: int) -> int:
    """`offset` as an int, checked: the indices offset .. offset + batch - 1
    of a launch's samples must be 32-bit words."""
    offset = int(offset)
    if offset < 0 or offset + int(batch) > INDEX_LIMIT:
        raise ValueError(f"sample offset {offset} with {batch} samples leaves the 32-bit "
                         f"sample index (offset + batch must be at most 2**32)")
    return offset


def sample_indices(batch: int, device=None, offset: int = 0) -> torch.Tensor:
    """The hash indices [batch] (int64) of a launch's samples: sample b
    hashes on offset + b, as the kernels' wave entries do, so a launch at
    offset o is rows [o, o + batch) of the launch at offset 0."""
    offset = check_offset(offset, batch)
    return torch.arange(offset, offset + int(batch), device=device)


def stream_seed(seed: int, index: int, stream: int) -> int:
    """A uint32 seed for `stream` of run `index` under a base `seed`.

    The ABC wave loop draws wave i's prior seed and simulation seed as two
    distinct streams of (seed, i), so any wave can be recomputed from the
    base seed and its index alone, which is what makes resume exact.
    """
    # analysis: allow(host-sync-in-wave-loop) — the loops pass Python ints,
    # hashed as ints on the host: int() of an int reads no tensor
    return int(_hash(_word(seed), _word(index), _word(stream)))
