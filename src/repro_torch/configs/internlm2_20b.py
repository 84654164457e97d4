"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. GQA. [arXiv:2403.17297; hf]"""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="internlm2-20b",
        family="decoder",
        cfg=DecoderConfig(
            name="internlm2-20b",
            n_layers=48,
            d_model=6144,
            n_heads=48,
            n_kv_heads=8,
            head_dim=128,
            d_ff=16384,
            vocab=92544,
            act="silu",
            rope_theta=1_000_000.0,
            tie_embed=False,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="internlm2-20b-smoke",
        family="decoder",
        cfg=DecoderConfig(
            name="internlm2-20b-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            act="silu",
            rope_theta=1_000_000.0,
            tie_embed=False,
            remat="none",
        ),
    )


register("internlm2-20b", full, smoke)
