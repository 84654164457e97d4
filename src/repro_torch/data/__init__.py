"""Training data of the port: `repro`'s synthetic token stream."""

from repro_torch.data.pipeline import SyntheticTokenDataset, make_batches

__all__ = ["SyntheticTokenDataset", "make_batches"]
