"""Architecture configs of the port; importing this package registers them.

Counterpart of `repro.configs` for the archs the port serves: gemma-2b;
gemma2-27b, whose smoke config holds local windows, soft-caps, post-norms
and a Python-float query scale through the model; and the MoE decoders
deepseek-moe-16b (a dense prefix layer, shared experts) and
qwen3-moe-30b-a3b (GQA 8, 128 routed experts).
"""

from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    gemma2_27b,
    gemma_2b,
    qwen3_moe_30b_a3b,
)

ALL_ARCHS = (
    "gemma2-27b",
    "gemma-2b",
    "deepseek-moe-16b",
    "qwen3-moe-30b-a3b",
)
