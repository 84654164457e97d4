"""Architecture configs of the port; importing this package registers them.

Counterpart of `repro.configs` for the archs this slice serves: gemma-2b,
and gemma2-27b, whose smoke config holds local windows, soft-caps,
post-norms and a Python-float query scale through the model.
"""

from repro_torch.configs import gemma2_27b, gemma_2b  # noqa: F401

ALL_ARCHS = (
    "gemma2-27b",
    "gemma-2b",
)
