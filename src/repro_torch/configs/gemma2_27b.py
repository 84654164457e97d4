"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000. Local+global alternating, logit softcap. [arXiv:2408.00118; hf]

gemma2 specifics: GeGLU, (local 4096, global) alternation, attn softcap 50,
final logit softcap 30, post-attn/post-ffn RMSNorms, embeddings scaled by
sqrt(d_model), query scale 1/sqrt(query_pre_attn_scalar=128) ~ per-head-dim.
long_500k is SKIPPED: half the layers are global full attention
(DESIGN.md §Arch-applicability)."""

from repro_torch.models.decoder import DecoderConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="gemma2-27b",
        family="decoder",
        cfg=DecoderConfig(
            name="gemma2-27b",
            n_layers=46,
            d_model=4608,
            n_heads=32,
            n_kv_heads=16,
            head_dim=128,
            d_ff=36864,
            vocab=256_000,
            act="gelu",
            attn_pattern=("local", "global"),
            window=4096,
            attn_softcap=50.0,
            final_softcap=30.0,
            query_scale=(4608 / 32) ** -0.5,  # query_pre_attn_scalar = d/heads
            embed_scale=True,
            post_norms=True,
            tie_embed=True,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="gemma2-27b-smoke",
        family="decoder",
        cfg=DecoderConfig(
            name="gemma2-27b-smoke",
            n_layers=4,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=256,
            vocab=512,
            act="gelu",
            attn_pattern=("local", "global"),
            window=8,
            attn_softcap=50.0,
            final_softcap=30.0,
            query_scale=(64 / 4) ** -0.5,
            embed_scale=True,
            post_norms=True,
            tie_embed=True,
            remat="none",
        ),
    )


register("gemma2-27b", full, smoke)
