"""ctypes wrapper of the device wave loop's compaction kernel
(`csrc/abc_compact.cu`), which `core.abc.compact_accepted` launches for
CUDA tensors.

    new_fill = compact_rows(th_buf, d_buf, fill, theta, dist, accept, capacity)

copies accepted row i of the wave, of rank r among the accepted rows in
stream order, to buffer row fill + r while that is below `capacity`, drops
the rest, and returns a new int64 [1] tensor `fill + accepted` (unclamped);
`fill` itself is not updated. Rejected rows are not touched, nor is the
spare row `capacity`. One launch on the current stream of the tensors'
device; nothing is read back to the host.

The kernel's status words (a ticket, a count of finished tiles and a word
a tile) are one zeroed int64 tensor a (device, stream), made here and grown
when a batch needs more tiles. Every launch finds them zero and leaves
them so (its last tile zeroes them), so launches keep no host state and a
CUDA graph may replay one. A caller that captures launches hands them words
of its own (`status_words`, made outside the graph, and `words=`), which
nothing else uses and which live as long as the graph does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int

#: the zeroed status words of each (device index, stream)
_WORDS: Dict[Tuple[int, int], torch.Tensor] = {}
_TILE = 0


def load() -> ctypes.CDLL:
    """The compaction library, typed on first use (`build.load` builds every
    source at once, so the runner's simulator has built it in set-up)."""
    global _TILE
    lib = build.load("abc_compact")
    if not _TILE:
        lib.abc_compact.argtypes = [_VP, _VP, _VP, _LL, _INT, _VP, _LL, _VP, _VP, _VP, _VP, _VP]
        lib.abc_compact.restype = _INT
        lib.kernel_error_string.argtypes = [_INT]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.abc_compact_tile.argtypes = []
        lib.abc_compact_tile.restype = _INT
        _TILE = lib.abc_compact_tile()
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}"
        )


def status_words(dev: torch.device, batch: int) -> torch.Tensor:
    """New zeroed status words on `dev` for launches of up to `batch` rows."""
    load()
    return torch.zeros((2 + -(-batch // _TILE),), dtype=torch.int64, device=dev)


def compact_rows(th_buf: torch.Tensor, d_buf: torch.Tensor, fill: torch.Tensor,
                 theta: torch.Tensor, dist: torch.Tensor, accept: torch.Tensor,
                 capacity: int, words: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the compaction of one wave (module docstring) and return its
    new fill. theta [B, p] and dist [B] float32, accept [B] bool, fill [1]
    int64, th_buf [capacity + 1, p] and d_buf [capacity + 1] float32, all
    contiguous on one CUDA device; anything else raises ValueError. `words`
    are the caller's status words (`status_words`), None the (device,
    stream)'s own."""
    dev = theta.device
    if theta.ndim != 2 or theta.shape[0] < 1 or theta.shape[1] < 1:
        raise ValueError(f"theta must be [B, p] with B, p >= 1, got {tuple(theta.shape)}")
    batch, p = theta.shape
    if batch >= 2 ** 31 or capacity < 0:
        raise ValueError(f"the kernel takes fewer than 2**31 rows and a capacity >= 0, got "
                         f"{batch} rows and capacity {capacity}")
    _check("theta", theta, torch.float32, (batch, p), dev)
    _check("dist", dist, torch.float32, (batch,), dev)
    _check("accept", accept, torch.bool, (batch,), dev)
    _check("fill", fill, torch.int64, (1,), dev)
    _check("th_buf", th_buf, torch.float32, (capacity + 1, p), dev)
    _check("d_buf", d_buf, torch.float32, (capacity + 1,), dev)
    if dev.type != "cuda":
        raise ValueError(f"the compaction kernel takes CUDA tensors, got them on {dev}")
    lib = load()
    tiles = -(-batch // _TILE)
    if words is not None:
        _check("words", words, torch.int64, (max(words.numel(), 2 + tiles),), dev)
    new_fill = torch.empty((1,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if words is None:
            words = _WORDS.get((dev.index, stream))
            if words is None or words.numel() < 2 + tiles:
                words = _WORDS[(dev.index, stream)] = status_words(dev, batch)
        rc = lib.abc_compact(theta.data_ptr(), dist.data_ptr(), accept.data_ptr(), batch, p,
                             fill.data_ptr(), capacity, th_buf.data_ptr(), d_buf.data_ptr(),
                             new_fill.data_ptr(), words.data_ptr(), stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"abc_compact launch failed: {msg} (cudaError {rc})")
    return new_fill
