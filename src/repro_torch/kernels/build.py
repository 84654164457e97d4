"""Build the port's CUDA kernels with nvcc at first use.

Each `csrc/*.cu` becomes a shared library with a plain C interface, loaded
with `ctypes`; no PyTorch header is compiled. The libraries go to
`build/kernels/` at the root of the checkout (listed in `.gitignore`),
named by a hash of the source, the `csrc/` headers it includes and its
flags, so an unchanged source reuses its build and a changed one rebuilds.

Every source is built with `NVCC_FLAGS`; every `abc_sim*` source (one a
model, `abc_sim_<model>`) adds `ABC_SIM_FLAGS`, `--fmad=false`, on which
its bitwise agreement with the plain version rests, while the two
flash-attention sources let nvcc fuse multiply-adds.

Each source that needs building is compiled by its own nvcc, all of them
started together, so a build takes as long as its slowest source.
`nvcc -Xptxas -v` reports each kernel's registers, shared memory and
spills; the report is kept beside the library and parsed into `BuildInfo`.
`sass_counts` counts an opcode (e.g. HGMMA) in each kernel of a built
library from `cuobjdump -sass` (`sass_text`); `kernels/sass.py` reads the
same listing for its instruction census.

    from repro_torch.kernels import build
    lib = build.load("abc_sim_siard")          # builds on first use
    build.build_all()["abc_sim_siard"].kernels  # {mangled kernel name: {...}}
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.ioutils import atomic_write_text

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
ABC_SIM_FLAGS = ("--fmad=false",)


@dataclasses.dataclass
class BuildInfo:
    """One built source: its library, how long nvcc took and what ptxas said."""

    name: str
    path: Path
    seconds: float  # this source's nvcc wall time; 0.0 when reused
    cached: bool
    #: per kernel: registers, smem_bytes, stack_bytes, spill_stores, spill_loads
    kernels: Dict[str, Dict[str, int]]


_LIBS: Dict[str, ctypes.CDLL] = {}
_INFO: Dict[str, BuildInfo] = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built with it at first use"
    )


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def flags(name: str) -> tuple:
    """nvcc flags of `csrc/<name>.cu` (or of a copy of it named so)."""
    return NVCC_FLAGS + (ABC_SIM_FLAGS if name.startswith("abc_sim") else ())


def local_headers(src: Path) -> List[Path]:
    """The csrc/ headers that `src` includes, directly or through another."""
    seen: Dict[str, Path] = {}
    todo = [src]
    while todo:
        text = todo.pop().read_text()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            p = CSRC / name
            if name not in seen and p.is_file():
                seen[name] = p
                todo.append(p)
    return [seen[n] for n in sorted(seen)]


def _digest(src: Path) -> str:
    """Hash of this source, the csrc/ headers it includes and its flags."""
    h = hashlib.sha256()
    for p in [src] + local_headers(src):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags(src.stem)).encode())
    return h.hexdigest()[:16]


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, shared memory, stack and spills of each kernel in a
    `-Xptxas -v` report, under the kernel's name as the report gives it."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {"registers": 0, "smem_bytes": 0,
                                     "stack_bytes": 0, "spill_stores": 0,
                                     "spill_loads": 0})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[current]["stack_bytes"] = int(m.group(1))
            out[current]["spill_stores"] = int(m.group(2))
            out[current]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[current]["smem_bytes"] = int(m.group(1))
    return out


def _nvcc(name: str, src: Path, lib: Path) -> BuildInfo:
    """Compile one source into `lib`; raises with nvcc's output on failure."""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *flags(name), "-I", str(CSRC), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    atomic_write_text(lib.with_suffix(".ptxas.txt"), proc.stdout)
    return BuildInfo(name, lib, seconds, False, parse_ptxas(proc.stdout))


def build_all() -> Dict[str, BuildInfo]:
    """Build (or reuse) every csrc/*.cu: one nvcc for each source that needs
    building, all started together."""
    todo = []
    for src in sources():
        name = src.stem
        if name in _INFO:
            continue
        lib = BUILD_DIR / f"{name}-{_digest(src)}.so"
        log = lib.with_suffix(".ptxas.txt")
        if lib.exists() and log.exists():
            _INFO[name] = BuildInfo(name, lib, 0.0, True, parse_ptxas(log.read_text()))
        else:
            todo.append((name, src, lib))
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            futures = [pool.submit(_nvcc, *job) for job in todo]
            for (name, _, _), fut in zip(todo, futures):
                _INFO[name] = fut.result()
    return dict(_INFO)


def cuobjdump_path() -> Optional[str]:
    """cuobjdump beside nvcc, on PATH, or None where the toolkit lacks it."""
    try:
        beside = Path(nvcc_path()).with_name("cuobjdump")
    except RuntimeError:
        beside = None
    if beside is not None and os.access(beside, os.X_OK):
        return str(beside)
    return shutil.which("cuobjdump")


def parse_sass_counts(sass: str, opcode: str) -> Dict[str, int]:
    """Lines whose instruction is `opcode` (e.g. HGMMA, with any suffix) in
    each function of a `cuobjdump -sass` listing, under its mangled name."""
    out: Dict[str, int] = {}
    current = None
    pattern = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?" + re.escape(opcode) + r"\b")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            out.setdefault(current, 0)
        elif current is not None and pattern.search(line):
            out[current] += 1
    return out


def sass_text(name: str) -> Optional[str]:
    """`cuobjdump -sass` of the built `csrc/<name>.cu`, or None without
    cuobjdump."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    proc = subprocess.run([tool, "-sass", str(build_all()[name].path)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          check=True)
    return proc.stdout


def sass_counts(name: str, opcode: str) -> Optional[Dict[str, int]]:
    """`parse_sass_counts` of the built `csrc/<name>.cu`, or None without
    cuobjdump."""
    text = sass_text(name)
    return None if text is None else parse_sass_counts(text, opcode)


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from `csrc/<name>.cu` (built on first use)."""
    if name not in _LIBS:
        info = build_all().get(name)
        if info is None:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        _LIBS[name] = ctypes.CDLL(str(info.path))
    return _LIBS[name]
