"""Registry of the port's compartmental models.

The models of `repro.epi.models`, registered in its order: siard (the
paper's default), sir, seir, seiard and the 4-region metapopulation
metapop_seir; then the port's own li2020 (Li et al., Science 2020: cities
coupled by travellers), which `repro` does not have. Each has a C++ struct
beside it for the CUDA kernel (`kernels/csrc/<model>.cuh`).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

from repro_torch.epi.spec import CompartmentalModel

_REGISTRY: Dict[str, CompartmentalModel] = {}


def register(model: CompartmentalModel) -> CompartmentalModel:
    """Add a model spec to the registry; a different spec under a taken
    name raises."""
    existing = _REGISTRY.get(model.name)
    if existing is not None and existing != model:
        raise ValueError(f"model {model.name!r} already registered with a different spec")
    _REGISTRY[model.name] = model
    return model


def get_model(model: Union[str, CompartmentalModel]) -> CompartmentalModel:
    """Resolve a registry name (or pass a spec through)."""
    if isinstance(model, CompartmentalModel):
        return model
    try:
        return _REGISTRY[model]
    except KeyError:
        raise KeyError(
            f"unknown model {model!r}; registered: {list_models()}"
        ) from None


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


from repro_torch.epi.models import siard as _siard  # noqa: E402
from repro_torch.epi.models import sir as _sir  # noqa: E402, F401
from repro_torch.epi.models import seir as _seir  # noqa: E402, F401
from repro_torch.epi.models import seiard as _seiard  # noqa: E402, F401
from repro_torch.epi.models import metapop_seir as _metapop_seir  # noqa: E402, F401
from repro_torch.epi.models import li2020 as _li2020  # noqa: E402, F401

DEFAULT_MODEL = _siard.MODEL

__all__ = ["CompartmentalModel", "DEFAULT_MODEL", "get_model", "list_models", "register"]
