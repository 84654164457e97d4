"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
GeGLU, head_dim=256 (explicit, != d_model/n_heads), MQA. [arXiv:2403.08295; hf]"""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="gemma-2b",
        family="decoder",
        cfg=DecoderConfig(
            name="gemma-2b",
            n_layers=18,
            d_model=2048,
            n_heads=8,
            n_kv_heads=1,
            head_dim=256,
            d_ff=16384,
            vocab=256_000,
            act="gelu",
            embed_scale=True,
            tie_embed=True,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="gemma-2b-smoke",
        family="decoder",
        cfg=DecoderConfig(
            name="gemma-2b-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=1,
            head_dim=32,  # head_dim decoupled from d_model/heads, like gemma
            d_ff=128,
            vocab=512,
            act="gelu",
            embed_scale=True,
            tie_embed=True,
            remat="none",
        ),
    )


register("gemma-2b", full, smoke)
