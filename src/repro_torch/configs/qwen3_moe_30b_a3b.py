"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768 (expert
width) vocab=151936, MoE 128 experts top-8, no shared experts.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="qwen3-moe-30b-a3b",
        family="decoder",
        cfg=DecoderConfig(
            name="qwen3-moe-30b-a3b",
            n_layers=48,
            d_model=2048,
            n_heads=32,
            n_kv_heads=4,
            head_dim=128,
            d_ff=768,
            vocab=151_936,
            act="silu",
            rope_theta=1_000_000.0,
            tie_embed=False,
            moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0),
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="qwen3-moe-30b-a3b-smoke",
        family="decoder",
        cfg=DecoderConfig(
            name="qwen3-moe-30b-a3b-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=32,
            vocab=512,
            act="silu",
            tie_embed=False,
            moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=0),
            remat="none",
        ),
    )


register("qwen3-moe-30b-a3b", full, smoke)
