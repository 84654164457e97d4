"""Optimizers of the port: `repro`'s AdamW (`optim.adamw`) and its int8
gradient compression with error feedback (`optim.compress`)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                                    cosine_schedule)
from repro_torch.optim.compress import compress_gradients, decompress_gradients

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_", "compress_gradients",
           "cosine_schedule", "decompress_gradients"]
