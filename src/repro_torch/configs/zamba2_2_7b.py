"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560 ssm_state=64 +
SHARED attention block (32H kv=32, d_ff=10240) applied every 6 layers with
concat(hidden, embedding) input. Runs long_500k (hybrid decode is O(S) in
memory, not quadratic). Simplifications vs HF noted in hybrid.py docstring.
[arXiv:2411.15242; hf]"""

from repro_torch.models.hybrid import HybridConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="zamba2-2.7b",
        family="hybrid",
        cfg=HybridConfig(
            name="zamba2-2.7b",
            n_layers=54,
            d_model=2560,
            d_state=64,
            vocab=32_000,
            n_heads=32,
            n_kv_heads=32,
            head_dim=80,
            d_ff=10_240,
            shared_every=6,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        cfg=HybridConfig(
            name="zamba2-2.7b-smoke",
            n_layers=4,
            d_model=64,
            d_state=16,
            vocab=512,
            n_heads=4,
            n_kv_heads=4,
            head_dim=16,
            d_ff=128,
            shared_every=2,
            chunk=16,
            remat="none",
        ),
    )


register("zamba2-2.7b", full, smoke)
