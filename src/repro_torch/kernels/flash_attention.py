"""ctypes wrapper of the forward flash-attention kernels.

Counterpart of `repro.kernels.flash_attention.flash_attention_kernel`, which
launched the TPU kernel. It takes the model layout that `repro`'s
`kernels.ops.flash_attention` took, q [B, Sq, H, D] and k, v [B, Skv, KH, D],
float32 or bfloat16, D <= 256, H a multiple of KH, and hands the kernel the
batch, sequence and head strides: nothing is transposed, padded or copied,
as long as the last dimension is contiguous. The output [B, Sq, H, D] in
q's dtype is allocated here with `torch.empty`.

Two kernels on the tensor cores, chosen by dtype (`route`):

- bf16 goes to `csrc/flash_attention_wgmma.cu` (wgmma, scores and
  accumulator in float32, p split into bf16 hi + lo). It reads rows in
  16-byte pieces where they are such pieces: D a multiple of 8, every base
  16-byte aligned and every stride a multiple of 8; any other layout it
  stages element by element.
- float32 goes to `csrc/flash_attention_tf32.cu` (3xTF32 wgmma: q, k, p
  and v each split into TF32 hi + lo, three products for each, which keeps
  the float32 bar). It takes one more argument, a scratch of
  `flash_f32_tc_scratch_bytes` bytes allocated here, into which it splits
  K and V once a call. It reads K and V rows in 16-byte pieces where D is a
  multiple of 4, every base 16-byte aligned and every stride a multiple of
  4; any other layout element by element.

So every layout `repro`'s `ops.flash_attention` takes runs, as it did there.
The kernel (`route`) and its loads (`staged`) are chosen here, before the
launch, and passed to it: the C entry reads rows in 16-byte pieces only when
told to, and refuses that for a layout that is not such pieces. Nothing
falls back from one kernel or one way of reading to the other.

`LAUNCHES` counts the launches of both; `LAUNCHES_TENSOR_CORE` (bf16) and
`LAUNCHES_TENSOR_CORE_F32` (float32) those of each route, and
`LAUNCHES_STAGED` those, of either, that staged their rows element by
element.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
TENSOR_CORE = "tensor_core"
TENSOR_CORE_F32 = "tensor_core_f32"
#: route -> (source in csrc/, exported function, its error-string function)
ROUTES = {
    TENSOR_CORE: ("flash_attention_wgmma", "flash_fwd_bf16", "flash_bf16_error_string"),
    TENSOR_CORE_F32: ("flash_attention_tf32", "flash_fwd_f32_tc", "flash_f32_tc_error_string"),
}

#: launches of either flash kernel
LAUNCHES = 0
#: launches of the bf16 tensor-core kernel
LAUNCHES_TENSOR_CORE = 0
#: launches of the float32 (3xTF32) tensor-core kernel
LAUNCHES_TENSOR_CORE_F32 = 0
#: launches, of either kernel, that staged rows element by element
LAUNCHES_STAGED = 0

_VP = ctypes.c_void_p
_fns: dict = {}


def _fn(route_name: str):
    """(kernel entry, error-string function, scratch-bytes function or None)
    of a route, built on first use. The float32 entry takes a scratch
    pointer after o."""
    if route_name not in _fns:
        source, entry, errstr = ROUTES[route_name]
        lib = build.load(source)
        fn = getattr(lib, entry)
        scratch = route_name == TENSOR_CORE_F32
        fn.argtypes = [
            _VP, _VP, _VP, _VP, *([_VP] if scratch else []), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, _VP,
        ]
        fn.restype = ctypes.c_int
        err = getattr(lib, errstr)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        nbytes = None
        if scratch:
            nbytes = lib.flash_f32_tc_scratch_bytes
            nbytes.argtypes = [ctypes.c_int] * 4
            nbytes.restype = ctypes.c_longlong
        _fns[route_name] = (fn, err, nbytes)
    return _fns[route_name]


def _grid(dtype: torch.dtype) -> int:
    """Elements of `dtype` in a 16-byte piece; raises on a dtype neither
    kernel takes."""
    if dtype == torch.float32:
        return 4
    if dtype == torch.bfloat16:
        return 8
    raise ValueError(f"q, k, v must all be float32 or all bfloat16, got {dtype}")


def route(dtype: torch.dtype) -> str:
    """The kernel that takes a call: `TENSOR_CORE` for bf16, `TENSOR_CORE_F32`
    for float32, whatever the layout (`staged` says how it reads the rows).
    Raises ValueError on a dtype neither kernel takes."""
    _grid(dtype)
    return TENSOR_CORE_F32 if dtype == torch.float32 else TENSOR_CORE


def staged(dtype: torch.dtype, d: int, strides: Sequence[int],
           data_ptrs: Sequence[int]) -> bool:
    """Whether the kernel stages the rows element by element: unless they are
    16-byte pieces, i.e. D a multiple of 8 bf16 or 4 float32 elements, every
    base (`data_ptrs` of q, k, v, o) 16-byte aligned and every element
    stride (batch, seq, head of each) a multiple of that grid. The answer is
    passed to the C entry (`flash_fwd_bf16`, `flash_fwd_f32_tc`), which
    refuses 16-byte pieces for a layout that is not such pieces."""
    grid = _grid(dtype)
    return bool(d % grid or any(p % 16 for p in data_ptrs) or any(s % grid for s in strides))


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: Optional[int], softcap: Optional[float]) -> None:
    """Raise ValueError on anything the kernels do not take."""
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
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or \
            v.dtype != q.dtype:
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
    """Launch the route's kernel on the current stream; returns o [B, Sq, H, D]."""
    global LAUNCHES, LAUNCHES_TENSOR_CORE, LAUNCHES_TENSOR_CORE_F32, LAUNCHES_STAGED
    check_args(q, k, v, window=window, softcap=softcap)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = float(1.0 / np.sqrt(d)) if scale is None else float(scale)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    tensors = (q, k, v, out)
    strides = np.asarray([t.stride(i) for t in tensors for i in range(3)], np.int64)
    ptrs = [t.data_ptr() for t in tensors]
    which = route(q.dtype)
    by_element = staged(q.dtype, d, strides.tolist(), ptrs)
    fn, err, scratch_bytes = _fn(which)
    scratch = [] if scratch_bytes is None else [torch.empty(
        scratch_bytes(b, kh, skv, d), dtype=torch.uint8, device=q.device)]
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *[t.data_ptr() for t in scratch], b, h, kh, sq, skv, d,
                strides.ctypes.data, int(by_element), int(bool(causal)),
                0 if window is None else int(window),
                0.0 if softcap is None else float(softcap), scale,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{ROUTES[which][1]} launch failed: {err(rc).decode()} "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    LAUNCHES_STAGED += by_element
    if which == TENSOR_CORE:
        LAUNCHES_TENSOR_CORE += 1
    else:
        LAUNCHES_TENSOR_CORE_F32 += 1
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
