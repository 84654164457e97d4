"""PyTorch/CUDA port of the `repro` package, slice by slice.

`repro_torch` mirrors the layout of `repro` (`epi/`, `epi/models/`,
`kernels/`, `core/`, `launch/`) so that each module's counterpart is easy to
find. It imports `torch` and numpy only, never `jax` and nothing of `repro`:
what it needs from there it keeps as its own copy.

The hot path, the fused tau-leap simulation with its running summary
distance, is a CUDA C++ kernel for Hopper (`kernels/csrc/abc_sim.cu`), built
with `nvcc` at first use. Beside it sits a plain PyTorch version of the same
function (`kernels/ref.py`), which is what a CPU tensor goes through.

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for `cuda` on a machine without a card raises (`repro_torch.device`).

This slice covers the paper's main path: rejection ABC of the flat SIARD
model, without intervention schedules.
"""
