"""Rules of the PyTorch port that hold on any machine.

* No module under src/repro_torch/, no experiment script under
  experiments/, and not chip_smoke.py, imports `jax`, `ml_dtypes` or
  anything of `repro`: the port keeps its own copies.
* Asking for device="cuda" without a card raises; nothing falls back to the
  CPU on its own.
* Every tests/test_torch_*.py pins torch's CPU threads to one at its top:
  under pytest-xdist each worker would otherwise spin a pool as wide as the
  machine, and six such pools on one machine's cores slow the suite many
  times over.
"""

import ast
import pathlib

import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.core import abc as tabc
from repro_torch.epi.data import get_dataset
from repro_torch.epi.models import get_model, list_models
from repro_torch.epi.spec import regionalize
from repro_torch.kernels import abc_sim, build
from repro_torch.launch import abc_run

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "experiments").glob("*.py")) + [ROOT / "chip_smoke.py"])


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
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))


def _pins_one_thread(path: pathlib.Path) -> bool:
    """Whether the module body calls torch.set_num_threads(1)."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        call = node.value if isinstance(node, ast.Expr) else None
        if (isinstance(call, ast.Call) and ast.unparse(call.func) == "torch.set_num_threads"
                and [ast.unparse(a) for a in call.args] == ["1"]):
            return True
    return False


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_tests_pin_torch_to_one_thread(path):
    assert _pins_one_thread(path), f"{path.name} does not call torch.set_num_threads(1) at its top"


def test_thread_rule_catches_what_it_must(tmp_path):
    cases = {"torch.set_num_threads(1)\n": True, "torch.set_num_threads(8)\n": False,
             "def f():\n    torch.set_num_threads(1)\n": False, "import torch\n": False}
    for i, (text, want) in enumerate(cases.items()):
        (tmp_path / f"t{i}.py").write_text(text)
        assert _pins_one_thread(tmp_path / f"t{i}.py") is want, text
    assert len(PORT_TESTS) >= 14


def test_import_rule_catches_what_it_must():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.abc")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.core.abc") and not _forbidden("torch")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_device_raises_without_a_card(no_card):
    launches = (dict(abc_sim.ENTRY_LAUNCHES), abc_sim.RNG_LAUNCHES)
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
    assert (abc_sim.ENTRY_LAUNCHES, abc_sim.RNG_LAUNCHES) == launches


def test_config_refuses_what_this_slice_lacks():
    from repro_torch.epi.spec import InterventionSchedule

    with pytest.raises(TypeError, match="InterventionSchedule"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, schedule=object())
    with pytest.raises(ValueError, match="not a parameter"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, model="sir",
                       schedule=InterventionSchedule.inferred(("alpha0",), (5,)))
    with pytest.raises(ValueError, match="backend"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, backend="pallas")
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        tabc.ABCConfig(batch_size=300, chunk_size=256)
    with pytest.raises(ValueError, match="multiple of 32"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, block=100)


#: one flat abc_sim source a flat model and one regional source a struct
#: (metapop_seir's and the flat models' regionalized), named by
#: `abc_sim.library`
FLAT = ("siard", "sir", "seir", "seiard")
ABC_SOURCES = {abc_sim.library(m) for m in FLAT}
REGIONAL_SOURCES = ({abc_sim.library(regionalize(get_model(m), 2)) for m in FLAT}
                    | {abc_sim.library("metapop_seir")})
SOURCES = ABC_SOURCES | REGIONAL_SOURCES | {"flash_attention_tf32", "flash_attention_wgmma",
                                            "abc_compact"}


def test_each_cuda_source_hashes_only_its_own_headers_and_flags():
    """A change to a flash-attention source does not rebuild abc_sim, nor a
    change to one model's struct another model's library, nor a change to
    the region axis a flat library; the abc_sim sources alone keep
    --fmad=false (their bitwise agreement rests on it), and the compaction
    kernel, which copies bits, takes nothing of theirs."""
    by_name = {src.stem: src for src in build.sources()}
    assert set(by_name) == SOURCES
    assert ABC_SOURCES == {"abc_sim_siard", "abc_sim_sir", "abc_sim_seir", "abc_sim_seiard"}
    assert REGIONAL_SOURCES == {f"abc_sim_regional_{m}" for m in FLAT + ("metapop_seir",)}
    assert {abc_sim.library(m) for m in list_models()} == ABC_SOURCES | {
        "abc_sim_regional_metapop_seir"}
    for model in FLAT:
        assert [p.name for p in build.local_headers(by_name[abc_sim.library(model)])] == [
            "abc_sim.cuh", "rng.cuh", f"{model}.cuh"]
    for model in FLAT + ("metapop_seir",):
        lib = f"abc_sim_regional_{model}"
        assert sorted(p.name for p in build.local_headers(by_name[lib])) == sorted([
            "abc_sim.cuh", "abc_sim_regional.cuh", "abc_sim_regional_warp.cuh", "rng.cuh",
            f"{model}.cuh"])
    assert abc_sim.RNG_LIBRARY == "abc_sim_siard"
    for flash in ("flash_attention_tf32", "flash_attention_wgmma"):
        assert [p.name for p in build.local_headers(by_name[flash])] == ["wgmma.cuh"]
    assert all("--fmad=false" in build.flags(n) for n in ABC_SOURCES | REGIONAL_SOURCES)
    assert "--fmad=false" not in build.flags("flash_attention_tf32")
    assert "--fmad=false" not in build.flags("flash_attention_wgmma")
    assert build.local_headers(by_name["abc_compact"]) == []
    assert "--fmad=false" not in build.flags("abc_compact")
    assert all("arch=compute_90a,code=sm_90a" in build.flags(n) for n in by_name)
    digests = {n: build._digest(src) for n, src in by_name.items()}
    assert len(set(digests.values())) == len(SOURCES)


def test_build_all_runs_one_nvcc_per_source_and_reuses_builds(tmp_path, monkeypatch):
    """With a stand-in nvcc (a shell script that writes its -o file and a
    ptxas line), every source is built once and then reused."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
        "echo built > \"$out\"\n"
        "echo \"ptxas info    : Compiling entry function 'k' for 'sm_90a'\"\n"
        "echo 'ptxas info    : Used 40 registers'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_INFO", {})
    first = build.build_all()
    assert set(first) == SOURCES
    for info in first.values():
        assert not info.cached and info.path.read_text() == "built\n"
        assert info.kernels == {"k": dict(registers=40, smem_bytes=0, stack_bytes=0,
                                          spill_stores=0, spill_loads=0)}
    monkeypatch.setattr(build, "_INFO", {})
    again = build.build_all()
    assert all(info.cached and info.seconds == 0.0 for info in again.values())


def test_build_all_starts_every_nvcc_together(tmp_path, monkeypatch):
    """Each stand-in nvcc waits until all of them have started: built one
    after the other, the first would give up after 20 s and write 1."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
        f"d={tmp_path}/started; mkdir -p $d; touch $d/$$\n"
        f"i=0; while [ $(ls $d | wc -l) -lt {len(SOURCES)} ] && [ $i -lt 200 ]; "
        "do sleep 0.1; i=$((i+1)); done\n"
        "ls $d | wc -l | tr -d ' ' > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_INFO", {})
    built = build.build_all()
    assert set(built) == SOURCES
    assert all(info.path.read_text() == f"{len(SOURCES)}\n" for info in built.values())


SASS = """
        code for sm_90a
                Function : _Z6kernelILi256EEvv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a10*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0a20*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0b30*/              @P0  HGMMA.64x256x16.F32.BF16 R88, R20, gdesc[UR12], R88, gsb0 ;
        /*0b40*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
                Function : _Z6kernelILi64EEvv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def test_sass_counts_count_an_opcode_in_each_function():
    assert build.parse_sass_counts(SASS, "HGMMA") == {
        "_Z6kernelILi256EEvv": 3, "_Z6kernelILi64EEvv": 0}
    assert build.parse_sass_counts(SASS, "HMMA") == {
        "_Z6kernelILi256EEvv": 0, "_Z6kernelILi64EEvv": 1}


def test_chip_smoke_and_the_gpu_tests_hold_the_same_flash_cases():
    """chip_smoke.py and tests/test_torch_gpu.py drive one list of cases."""
    from test_torch_gpu import FLASH_CASES

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    found = [ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) and
             any(getattr(t, "id", None) == "FLASH_CASES" for t in node.targets)]
    assert found == [FLASH_CASES]
