"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408 (expert
width) vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained; first layer
dense. [arXiv:2401.06066; hf]"""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="deepseek-moe-16b",
        family="decoder",
        cfg=DecoderConfig(
            name="deepseek-moe-16b",
            n_layers=28,
            d_model=2048,
            n_heads=16,
            n_kv_heads=16,
            head_dim=128,
            d_ff=1408,
            vocab=102_400,
            act="silu",
            tie_embed=False,
            moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
            n_dense_prefix=1,
            dense_prefix_ff=10944,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="deepseek-moe-16b-smoke",
        family="decoder",
        cfg=DecoderConfig(
            name="deepseek-moe-16b-smoke",
            n_layers=3,
            d_model=64,
            n_heads=4,
            n_kv_heads=4,
            head_dim=16,
            d_ff=32,
            vocab=512,
            act="silu",
            tie_embed=False,
            moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2),
            n_dense_prefix=1,
            dense_prefix_ff=128,
            remat="none",
        ),
    )


register("deepseek-moe-16b", full, smoke)
