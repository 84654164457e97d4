"""Architecture configs of the port; importing this package registers them.

Counterpart of `repro.configs`, every arch of `repro`'s: the dense decoders
internlm2-20b, gemma2-27b (local windows, soft-caps, post-norms and a
Python-float query scale), minitron-8b (relu2) and gemma-2b; the MoE
decoders deepseek-moe-16b (a dense prefix layer, shared experts) and
qwen3-moe-30b-a3b (GQA 8, 128 routed experts); the state-space
mamba2-130m; the encoder-decoder whisper-large-v3; the vision-language
internvl2-2b; and the hybrid zamba2-2.7b.
"""

from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    gemma2_27b,
    gemma_2b,
    internlm2_20b,
    internvl2_2b,
    mamba2_130m,
    minitron_8b,
    qwen3_moe_30b_a3b,
    whisper_large_v3,
    zamba2_2_7b,
)

ALL_ARCHS = (
    "internlm2-20b",
    "gemma2-27b",
    "minitron-8b",
    "gemma-2b",
    "deepseek-moe-16b",
    "qwen3-moe-30b-a3b",
    "whisper-large-v3",
    "mamba2-130m",
    "internvl2-2b",
    "zamba2-2.7b",
)
