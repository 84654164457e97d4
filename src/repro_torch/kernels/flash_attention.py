"""ctypes wrapper of the forward flash-attention kernel (`csrc/flash_attention.cu`).

Counterpart of `repro.kernels.flash_attention.flash_attention_kernel`, which
launched the TPU kernel. It takes the model layout that `repro`'s
`kernels.ops.flash_attention` took, q [B, Sq, H, D] and k, v [B, Skv, KH, D],
float32 or bfloat16, D <= 256, H a multiple of KH, and hands the kernel the
batch, sequence and head strides: nothing is transposed, padded or copied,
as long as the last dimension is contiguous. The output [B, Sq, H, D] in
q's dtype is allocated here with `torch.empty`.

`LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the flash kernel
LAUNCHES = 0

_VP = ctypes.c_void_p
_typed: set = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if "flash_attention" not in _typed:
        lib.flash_attention_fwd.argtypes = [
            ctypes.c_int, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, _VP,
        ]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        _typed.add("flash_attention")
    return lib


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: Optional[int], softcap: Optional[float]) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be 4-D [B, S, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be [{b}, Skv, KH, {d}], got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside the kernel's 1..{MAX_HEAD_DIM}")
    if min(sq, k.shape[1]) < 1:
        raise ValueError("empty query or key sequence")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")
    if softcap is not None and not float(softcap) > 0.0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous "
                             f"(strides {t.stride()})")


def flash_attention_kernel(
    q: torch.Tensor,  # [B, Sq, H, D] CUDA
    k: torch.Tensor,  # [B, Skv, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns o [B, Sq, H, D]."""
    global LAUNCHES
    check_args(q, k, v, window=window, softcap=softcap)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = float(1.0 / np.sqrt(d)) if scale is None else float(scale)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = np.asarray([t.stride(i) for t in (q, k, v, out) for i in range(3)], np.int64)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kh, sq, skv, d, strides.ctypes.data, int(bool(causal)),
            0 if window is None else int(window), 0.0 if softcap is None else float(softcap),
            scale, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    return out


def attention_flops(b: int, sq: int, skv: int, h: int, d: int, *, causal: bool = True) -> int:
    """Operations the function needs: 4 * D for each allowed (query, key)
    pair (2 * D for q . k, 2 * D for p @ v), with query i aligned to key i."""
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv, np.int64)
    pairs = int(hi.sum())
    return 4 * d * pairs * b * h


def attention_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Device bytes of one call: q, k, v read once and o written once."""
    return (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
