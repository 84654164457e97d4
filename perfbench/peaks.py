"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every roofline and mfu metric. A card
set below 700 W reaches less; each run reports its card's name."""

#: float32 operations a second outside the tensor cores
F32_OPS_PER_S = 67e12
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12
