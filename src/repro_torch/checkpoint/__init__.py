from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["Checkpointer", "load_checkpoint", "save_checkpoint"]
