"""Uniform model API (PyTorch), counterpart of `repro.models.registry`.

Each architecture is a `ModelDef` with the surface of `repro`'s:

  init_params(generator)                — parameters
  prefill(params, batch)                — prompt batch -> next-token logits [B, 1, V]
  decode_step(params, cache, batch)     — one-token serve step
  init_cache_shape / init_cache / cache_logical — decode state

The port has the decoder family, dense and MoE (`models.decoder`), the
ssm (`models.ssm`), hybrid (`models.hybrid`) and vlm (`models.vlm`)
families; the encdec family raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import decoder as dec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import vlm as vlm_lib

_FAMILIES = {"decoder": dec_lib, "ssm": ssm_lib, "hybrid": hybrid_lib, "vlm": vlm_lib}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    family: str
    cfg: Any

    def module(self):
        if self.family not in _FAMILIES:
            raise NotImplementedError(
                f"{self.name}: the {self.family!r} family is not ported yet (the port has "
                f"{sorted(_FAMILIES)})")
        return _FAMILIES[self.family]

    def with_cfg(self, **changes) -> "ModelDef":
        """This model with some config fields replaced (e.g. attn_impl="flash");
        a vlm passes the fields its own config lacks to its decoder's."""
        if self.family == "vlm":
            own = {f.name for f in dataclasses.fields(self.cfg)}
            lm = {k: v for k, v in changes.items() if k not in own}
            changes = {k: v for k, v in changes.items() if k in own}
            if lm:
                changes["lm"] = dataclasses.replace(changes.get("lm", self.cfg.lm), **lm)
        return dataclasses.replace(self, cfg=dataclasses.replace(self.cfg, **changes))

    # ----- params
    def init_params(self, generator: Optional[torch.Generator] = None, device="cuda"):
        """Random parameters; without a generator, one seeded 0 on `device`."""
        if generator is None:
            generator = torch.Generator(device=torch.device(device)).manual_seed(0)
        return self.module().init_params(generator, self.cfg)

    # ----- serve entry points
    def prefill(self, params, batch):
        """Serving prefill: next-token logits [B, 1, V] float32. The batch
        goes through whole: "tokens", and for a vlm "patch_embeds"."""
        return self.module().prefill_logits(params, batch, self.cfg)

    def decode_step(self, params, cache, batch):
        return self.module().decode_step(params, cache, batch["tokens"], batch["pos"],
                                         self.cfg)

    def init_cache_shape(self, batch: int, cache_len: int):
        return self.module().init_cache_shape(self.cfg, batch, cache_len)

    def init_cache(self, batch: int, cache_len: int, device="cuda"):
        return self.module().init_cache(self.cfg, batch, cache_len, device)

    def cache_logical(self):
        return self.module().cache_logical(self.cfg)

    # ----- stats
    def param_count(self) -> int:
        return self.cfg.param_count()

    def active_param_count(self) -> int:
        return self.cfg.active_param_count()


# --------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelDef]] = {}
_SMOKE: Dict[str, Callable[[], ModelDef]] = {}


def register(name: str, full: Callable[[], ModelDef], smoke: Callable[[], ModelDef]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_model(name: str, smoke: bool = False) -> ModelDef:
    _ensure_configs_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(table)}")
    return table[name]()


def list_archs() -> Tuple[str, ...]:
    _ensure_configs_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_configs_loaded():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import ALL_ARCHS  # noqa: F401  (import side effect)

    _LOADED = True
