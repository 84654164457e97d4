"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality), chunked matmul form. Runs the
long_500k shape (O(1)-state decode). [arXiv:2405.21060]"""

from repro_torch.models.registry import ModelDef, register
from repro_torch.models.ssm import Mamba2Config


def full() -> ModelDef:
    return ModelDef(
        name="mamba2-130m",
        family="ssm",
        cfg=Mamba2Config(
            name="mamba2-130m",
            n_layers=24,
            d_model=768,
            d_state=128,
            vocab=50_280,
            head_dim=64,
            expand=2,
            chunk=128,
        ),
    )


def smoke() -> ModelDef:
    return ModelDef(
        name="mamba2-130m-smoke",
        family="ssm",
        cfg=Mamba2Config(
            name="mamba2-130m-smoke",
            n_layers=2,
            d_model=64,
            d_state=16,
            vocab=512,
            head_dim=16,
            expand=2,
            chunk=16,
            remat="none",
        ),
    )


register("mamba2-130m", full, smoke)
