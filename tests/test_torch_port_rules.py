"""Rules of the PyTorch port that hold on any machine.

* No module under src/repro_torch/, and not chip_smoke.py, imports `jax` or
  anything of `repro`: the port keeps its own copies.
* Asking for device="cuda" without a card raises; nothing falls back to the
  CPU on its own.
"""

import ast
import pathlib

import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.core import abc as tabc
from repro_torch.epi.data import get_dataset
from repro_torch.kernels import abc_sim
from repro_torch.launch import abc_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_rule_catches_what_it_must():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.abc")
    assert not _forbidden("repro_torch.core.abc") and not _forbidden("torch")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_device_raises_without_a_card(no_card):
    launches = (abc_sim.LAUNCHES, abc_sim.RNG_LAUNCHES)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    ds = get_dataset("synthetic_small", num_days=5)
    cfg = tabc.ABCConfig(batch_size=256, chunk_size=256, num_days=5, max_runs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tabc.run_abc(ds, cfg)  # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        tabc.make_simulator(ds, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        abc_run.main(["--days", "5", "--batch", "256", "--chunk", "256"])
    with pytest.raises(ValueError, match="CUDA"):
        abc_sim.rng_normals(1, 4, 4, device="cpu")
    assert (abc_sim.LAUNCHES, abc_sim.RNG_LAUNCHES) == launches


def test_config_refuses_what_this_slice_lacks():
    with pytest.raises(NotImplementedError, match="later slice"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, schedule=object())
    with pytest.raises(ValueError, match="backend"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, backend="pallas")
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        tabc.ABCConfig(batch_size=300, chunk_size=256)
    with pytest.raises(ValueError, match="multiple of 32"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, block=100)
