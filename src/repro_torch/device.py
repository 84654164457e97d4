"""Device resolution for the port's entry points.

Entry points take a `device` argument that defaults to "cuda". Asking for a
card that is not there raises; nothing falls back to the CPU on its own.

It also holds the card's ceilings, the port's counterpart of
`repro.launch.analysis`'s `PEAK_FLOPS`/`HBM_BW`/`LINK_BW` (which are a TPU
v5e's): the bounds of `chip_smoke.py`, the roofline of `core.tuning` and
the dry run's (`launch.analysis`) read them here.
"""

from __future__ import annotations

import torch

#: H100 SXM published peaks (NVIDIA's data sheet): float32 outside
#: the tensor cores, bf16 and TF32 on the tensor cores (dense), and HBM
#: bandwidth
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
#: TF32 products for each float32 one in the float32 flash kernel (3xTF32:
#: a_hi b_hi + a_lo b_hi + a_hi b_lo); its bound counts all three
TF32_PASSES = 3
HBM_BYTES_PER_S = 3.35e12
#: the link a rank's collectives cross when a mesh axis spans hosts: one
#: InfiniBand NDR port of 400 Gb/s a GPU (NVIDIA DGX H100 user guide: eight
#: ConnectX-7 400 Gb/s ports, one a GPU), 50 GB/s each way. A 16-wide
#: "model" axis spans two 8-GPU nodes, so the dry run's collective term
#: divides by this
LINK_BYTES_PER_S = 50e9
#: NVLink 4 within a node (the H100 SXM data sheet: 900 GB/s a GPU, both
#: directions), for collectives that stay inside one 8-GPU node
NVLINK_BYTES_PER_S = 900e9


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a `torch.device`; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def card_label(device: str | torch.device = "cuda") -> str:
    """The card of `device` as `nvidia-smi --query-gpu=name,power.limit`
    names it ("NVIDIA H100 80GB HBM3, 700.00 W"), for records of measured
    numbers; "cpu" for the CPU."""
    import subprocess

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
