"""internvl2-2b [vlm] — InternViT (stub) + InternLM2-1.8B backbone:
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. Patch embeddings are
precomputed per brief; 2-layer MLP projector. [arXiv:2404.16821; hf]"""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.registry import ModelDef, register
from repro_torch.models.vlm import VLMConfig


def full() -> ModelDef:
    lm = DecoderConfig(
        name="internvl2-2b-lm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=92_553,
        act="silu",
        rope_theta=1_000_000.0,
        tie_embed=False,
    )
    return ModelDef(
        name="internvl2-2b",
        family="vlm",
        cfg=VLMConfig(name="internvl2-2b", lm=lm, vit_dim=1024, n_patches=256),
    )


def smoke() -> ModelDef:
    lm = DecoderConfig(
        name="internvl2-2b-lm-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        act="silu",
        tie_embed=False,
        remat="none",
    )
    return ModelDef(
        name="internvl2-2b-smoke",
        family="vlm",
        cfg=VLMConfig(name="internvl2-2b-smoke", lm=lm, vit_dim=32, n_patches=8),
    )


register("internvl2-2b", full, smoke)
