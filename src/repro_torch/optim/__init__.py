"""Optimizers of the port: `repro`'s AdamW (`optim.adamw`). Gradient
compression waits for the LM training slice."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule"]
