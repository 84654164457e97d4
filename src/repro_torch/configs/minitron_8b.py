"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000. Pruned nemotron: non-gated squared-ReLU MLP, untied embeddings.
[arXiv:2407.14679; hf]"""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="minitron-8b",
        family="decoder",
        cfg=DecoderConfig(
            name="minitron-8b",
            n_layers=32,
            d_model=4096,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            d_ff=16384,
            vocab=256_000,
            act="relu2",
            rope_theta=10_000.0,
            tie_embed=False,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="minitron-8b-smoke",
        family="decoder",
        cfg=DecoderConfig(
            name="minitron-8b-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            act="relu2",
            tie_embed=False,
            remat="none",
        ),
    )


register("minitron-8b", full, smoke)
