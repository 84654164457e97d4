"""Shared pieces of the `abc_sim` experiments: build a copy of a CUDA source
into `build/experiments/`, call its entries through ctypes, and time
functions in turns on one card.

    from abc_sim_common import build_copies, call_wave, turns

Used by `abc_sim_two_role.py`, `abc_sim_fmad.py` and `abc_sim_parent.py`
(run them on a machine with a CUDA card and nvcc; each prints one JSON line,
then the card's nvidia-smi name and power limit).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "experiments")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def build_copies(jobs):
    """Build each (tag, source text, nvcc flags, include dirs) into
    `build/experiments/<tag>.so`, all nvcc processes started together.
    Returns {tag: (ctypes library, cuobjdump -sass text, ptxas kernels)}."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for tag, text, flags, includes in jobs:
        cu = os.path.join(OUT, f"{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"{tag}.so")
        cmd = [build.nvcc_path(), *flags]
        for inc in includes:
            cmd += ["-I", str(inc)]
        procs[tag] = (lib, subprocess.Popen(cmd + ["-o", lib, cu], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
        tool = build.cuobjdump_path()
        sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout if tool else None
        out[tag] = (ctypes.CDLL(lib), sass, build.parse_ptxas(log))
    return out


def gated(csrc) -> bool:
    """Whether the abc_sim entries of the checkout whose `csrc/` directory
    this is take a trailing device gate."""
    head = next(p for p in (os.path.join(csrc, f) for f in ("abc_sim.cuh", "abc_sim.cu"))
                if os.path.isfile(p))
    return "gate" in open(head).read()


def takes_offset(csrc) -> bool:
    """Whether the abc_sim wave entries of the checkout whose `csrc/`
    directory this is take a trailing sample offset."""
    head = os.path.join(csrc, "abc_sim.cuh")
    return os.path.isfile(head) and "uint32_t offset" in open(head).read()


def takes_seeds(csrc) -> bool:
    """Whether the abc_sim wave entries of the checkout whose `csrc/`
    directory this is take trailing device seeds after the offset."""
    head = os.path.join(csrc, "abc_sim.cuh")
    return os.path.isfile(head) and "uint32_t* seeds" in open(head).read()


_VP, _INT, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
#: the C arguments of the flat entries and the thread and warp routes' wave
#: entry: the theta-in entries end with the block, the stream and the gate,
#: the wave entries with the block, the stream, the gate, the sample offset
#: and the device seeds
ARGTYPES = {
    "distance": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _VP],
    "wave": [_U32, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _VP, _U32, _VP],
    "regional_wave": [_U32, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                      _INT, _INT, _INT, _VP, _VP, _U32, _VP],
}


def argtypes(kind: str, takes_gate: bool, offset: bool = False, seeds: bool = False):
    """`ARGTYPES[kind]`, less the wave entries' trailing seeds for a
    checkout whose entries take none (`seeds`), less their offset for one
    whose entries take none (`offset`), and less the trailing gate for one
    whose entries take none."""
    types = list(ARGTYPES[kind])
    if kind.endswith("wave"):
        types = types[:len(types) - (not seeds) - (not offset)]
    return types if takes_gate else types[:-1]


def entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def call_wave(fn, prior, prior_seed, obs, fconst, iconst, batch, block=128, extra=(),
              gated=False, offset=None, seeds=False):
    """(theta [batch, P], dist [batch]) from an `abc_sim_wave_<model>`-shaped
    entry (`extra` goes before the arguments, e.g. a configuration index;
    `gated`: the entry takes a trailing gate, passed as null; `offset`: the
    entry takes a sample offset after it, passed as given; `seeds`: it takes
    device seeds after the offset, passed as null)."""
    import torch

    p = len(prior.lows)
    theta = torch.empty((batch, p), dtype=torch.float32, device=obs.device)
    dist = torch.empty((batch,), dtype=torch.float32, device=obs.device)
    lo = np.ascontiguousarray(prior.lows, np.float32)
    hi = np.ascontiguousarray(prior.highs, np.float32)
    args = [*extra, prior_seed, lo.ctypes.data, hi.ctypes.data, obs.data_ptr(),
            theta.data_ptr(), dist.data_ptr(), fconst.ctypes.data, iconst.ctypes.data, batch,
            obs.shape[1]]
    if block is not None:
        args.append(block)
    rc = fn(*args, stream(), *([None] if gated else []),
            *([] if offset is None else [offset]), *([None] if seeds else []))
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return theta, dist


def call_distance(fn, soa, obs, fconst, iconst, block=128, gated=False):
    """distances [B] from an `abc_sim_distance_<model>`-shaped entry
    (`gated`: it takes a trailing gate, passed as null)."""
    import torch

    out = torch.empty((soa.shape[1],), dtype=torch.float32, device=soa.device)
    rc = fn(soa.data_ptr(), obs.data_ptr(), out.data_ptr(), fconst.ctypes.data,
            iconst.ctypes.data, soa.shape[1], obs.shape[1], block, stream(),
            *([None] if gated else []))
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def turns(fns: dict, order, iters: int) -> dict:
    """Mean ms a call of each named function over its turns in `order`
    (e.g. a, b, b, a), each turn timed by CUDA events over `iters` calls."""
    from chip_smoke import cuda_ms

    got = {k: [] for k in fns}
    for k in order:
        got[k].append(cuda_ms(fns[k], iters))
    return {k: {"ms": float(np.mean(v)), "turns_ms": v} for k, v in got.items()}


def italy_inputs(dev, batch: int, seed: int = 99):
    """The timing inputs of chip_smoke.py: Italy's identity/euclidean
    summary, the packed constants (simulation seed `seed`), the paper prior
    and theta [batch, 8] drawn from it with prior seed 12."""
    from repro_torch.core.priors import paper_prior
    from repro_torch.core.summaries import get_summary, lower_summary
    from repro_torch.epi import data
    from repro_torch.kernels import abc_sim
    import torch

    italy = data.get_dataset("italy", num_days=49)
    kw = dict(population=italy.population, a0=italy.a0, r0=italy.r0, d0=italy.d0)
    lowered = lower_summary(get_summary(None), "euclidean",
                            torch.as_tensor(italy.observed, device=dev))
    fconst, iconst = abc_sim.pack_consts(
        mean_scale=lowered.mean_scale, weights=lowered.weights.cpu().numpy(),
        flags=lowered.flags, seed=seed, **kw)
    prior = paper_prior()
    return dict(obs=lowered.obs_summary.contiguous(), observed=italy.observed, kw=kw,
                lowered=lowered, fconst=fconst, iconst=iconst, prior=prior,
                theta=prior.sample(12, batch, dev))
