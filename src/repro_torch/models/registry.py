"""Uniform model API (PyTorch), counterpart of `repro.models.registry`.

Each architecture is a `ModelDef` with the surface of `repro`'s:

  init_params(generator)                — parameters
  loss(params, batch)                   — training objective (CE + MoE aux)
  prefill(params, batch)                — prompt batch -> next-token logits [B, 1, V]
  decode_step(params, cache, batch)     — one-token serve step
  init_cache_shape / init_cache / cache_logical — decode state
  make_inputs(mode, batch, seq)         — input shapes and dtypes, and their logical axes
  example_inputs(mode, batch, seq)      — a concrete batch of those shapes, from a seed

over every family of `repro`: the decoder, dense and MoE
(`models.decoder`), the ssm (`models.ssm`), hybrid (`models.hybrid`),
encoder-decoder (`models.encdec`) and vlm (`models.vlm`), with the
parameters' logical axes (`param_logical`, mapped to mesh axes by
`models.sharding`) and their shapes and dtypes on the meta device
(`param_shapes`, nothing allocated).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.models import decoder as dec_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import vlm as vlm_lib
from repro_torch.models.decoder import TensorSpec

_FAMILIES = {"decoder": dec_lib, "ssm": ssm_lib, "hybrid": hybrid_lib, "encdec": encdec_lib,
             "vlm": vlm_lib}
I32 = torch.int32


class _MetaFactories(torch.overrides.TorchFunctionMode):
    """Every tensor made in the block is made on the meta device, whatever
    device the caller names."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    family: str
    cfg: Any

    def module(self):
        if self.family not in _FAMILIES:
            raise NotImplementedError(
                f"{self.name}: no {self.family!r} family (the port has {sorted(_FAMILIES)})")
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

    def param_shapes(self):
        """The tree of `init_params` as meta tensors: shapes and dtypes, no
        storage and no draws."""
        with _MetaFactories():
            return self.init_params(torch.Generator(), device="cpu")

    def param_logical(self):
        """Logical axes of `init_params`' tree, leaf for leaf."""
        return self.module().param_logical(self.cfg)

    # ----- train / serve entry points
    def loss(self, params, batch):
        """The training objective: a float32 scalar, differentiable in the
        parameters (the flash route refuses a gradient)."""
        return self.module().loss_fn(params, batch, self.cfg)

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

    @property
    def sub_quadratic(self) -> bool:
        return bool(getattr(self.cfg, "sub_quadratic", False))

    @property
    def vocab(self) -> int:
        return self.cfg.lm.vocab if self.family == "vlm" else self.cfg.vocab

    # ----- inputs
    def make_inputs(self, mode: str, batch: int, seq: int) -> Tuple[dict, dict]:
        """(shapes and dtypes {name: TensorSpec}, logical axes {name: tuple})
        of a "train", "prefill" or "decode" batch, as `repro`'s
        `make_inputs` lays it out: a vlm's `seq` counts its patch rows, an
        encdec's is the encoder's frames and its decoder takes
        max(seq // dec_ratio, 8) tokens; "train" adds labels as long as the
        model's row; decode is one token and a write position."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r} is not train, prefill or decode")
        if mode == "decode":
            return ({"tokens": TensorSpec((batch, 1), I32), "pos": TensorSpec((), I32)},
                    {"tokens": ("batch", None), "pos": ()})
        if self.family == "vlm":
            npatch = self.cfg.n_patches
            spec = {"patch_embeds": TensorSpec((batch, npatch, self.cfg.vit_dim),
                                               cm.DEFAULT_DTYPE),
                    "tokens": TensorSpec((batch, seq - npatch), I32)}
            logical = {"patch_embeds": ("batch", "seq", None), "tokens": ("batch", "seq")}
            label_len = seq
        elif self.family == "encdec":
            label_len = max(seq // self.cfg.dec_ratio, 8)
            spec = {"frames": TensorSpec((batch, seq, self.cfg.d_model), cm.DEFAULT_DTYPE),
                    "tokens": TensorSpec((batch, label_len), I32)}
            logical = {"frames": ("batch", "seq", None), "tokens": ("batch", "seq")}
        else:
            spec = {"tokens": TensorSpec((batch, seq), I32)}
            logical = {"tokens": ("batch", "seq")}
            label_len = seq
        if mode == "train":
            spec["labels"] = TensorSpec((batch, label_len), I32)
            logical["labels"] = ("batch", "seq")
        return spec, logical

    def example_inputs(self, mode: str, batch: int, seq: int, device="cuda",
                       seed: int = 0) -> Dict[str, torch.Tensor]:
        """A concrete batch of `make_inputs`' shapes on `device`, from numpy
        (`default_rng(seed)`, the names in sorted order): token ids and
        labels uniform in [0, vocab), float inputs standard normal cast to
        their dtype, and a decode write position of seq - 1."""
        spec, _ = self.make_inputs(mode, batch, seq)
        rng = np.random.default_rng(seed)
        out = {}
        for name in sorted(spec):
            s = spec[name]
            if name == "pos":
                a = np.asarray(seq - 1, np.int32)
            elif s.dtype == I32:
                a = rng.integers(0, self.vocab, size=s.shape).astype(np.int32)
            else:
                a = rng.standard_normal(s.shape, dtype=np.float32)
            out[name] = torch.from_numpy(a).to(device=device, dtype=s.dtype)
        return out


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
