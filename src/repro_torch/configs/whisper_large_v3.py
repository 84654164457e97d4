"""whisper-large-v3 [audio] — enc-dec backbone, 32+32L d_model=1280 20H (MHA
kv=20) d_ff=5120 vocab=51866. The conv frontend is stubbed as in `repro`:
inputs are frame embeddings, and a learned linear adapter stands in for the
conv stack. [arXiv:2212.04356]"""

from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.registry import ModelDef, register


def full() -> ModelDef:
    return ModelDef(
        name="whisper-large-v3",
        family="encdec",
        cfg=EncDecConfig(
            name="whisper-large-v3",
            n_enc_layers=32,
            n_dec_layers=32,
            d_model=1280,
            n_heads=20,
            n_kv_heads=20,
            head_dim=64,
            d_ff=5120,
            vocab=51_866,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="whisper-large-v3-smoke",
        family="encdec",
        cfg=EncDecConfig(
            name="whisper-large-v3-smoke",
            n_enc_layers=2,
            n_dec_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=4,
            head_dim=16,
            d_ff=128,
            vocab=512,
            max_dec_len=64,
            remat="none",
        ),
    )


register("whisper-large-v3", full, smoke)
