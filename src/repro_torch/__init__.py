"""PyTorch/CUDA port of the `repro` package, slice by slice.

`repro_torch` mirrors the layout of `repro` (`epi/`, `epi/models/`,
`kernels/`, `core/`, `models/`, `configs/`, `launch/`) so that each module's
counterpart is easy to find. It imports `torch` and numpy only, never
`jax` and nothing of `repro`: what it needs from there it keeps as its own
copy.

Each kernel that `repro` wrote in Pallas is a CUDA C++ kernel for Hopper,
built with `nvcc` at first use: the fused tau-leap simulation with its
running summary distance (`kernels/csrc/abc_sim.cuh`, and its region axis
for metapopulation models, `kernels/csrc/abc_sim_regional.cuh`) and forward flash
attention on the tensor cores, in bf16 (`kernels/csrc/flash_attention_wgmma.cu`)
and in float32 as 3xTF32 (`kernels/csrc/flash_attention_tf32.cu`). Beside
each sits a plain PyTorch version of the same function (`kernels/ref.py`), which is what a
CPU tensor goes through.

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for `cuda` on a machine without a card raises (`repro_torch.device`).

Slice 1 covers the paper's main path: rejection ABC of the flat SIARD
model. Slice 2 covers serving the dense decoder LM (gemma-2b, gemma2-27b):
prefill through the flash kernel and continuous-batching decode. Later
slices add the other models, intervention schedules and, in slice 7,
metapopulations (`epi.spec.regionalize`, `metapop_seir`). On the card the
ABC waves draw theta inside the fused kernel (its wave entry), one launch
a wave.
"""
