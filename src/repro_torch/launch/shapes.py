"""The input shapes of the LM families (port of `repro.launch.shapes`).

`decode_*` and `long_*` build the serving step (one token against a KV
cache of seq_len), not the training step. `long_500k` needs sub-quadratic
attention and applies only to the ssm and hybrid archs."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.models.registry import ModelDef


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    mode: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}

SHAPE_ORDER: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicable(model: ModelDef, shape_name: str) -> bool:
    """long_500k only for sub-quadratic archs; every other shape for all."""
    if shape_name == "long_500k":
        return model.sub_quadratic
    return True


def cells(archs, shapes=SHAPE_ORDER):
    """(arch, shape name) for each arch and each shape that applies to it."""
    from repro_torch.models.registry import get_model

    for a in archs:
        m = get_model(a)
        for s in shapes:
            if applicable(m, s):
                yield a, s
