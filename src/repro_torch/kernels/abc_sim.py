"""ctypes wrapper of the fused ABC simulation kernel (`csrc/abc_sim.cuh`)
and of its region axis (`csrc/abc_sim_regional.cuh`,
`csrc/abc_sim_regional_warp.cuh`, `csrc/abc_sim_regional_tile.cuh`).

Counterpart of `repro.kernels.abc_sim.abc_sim_distance_kernel`, which
launched the TPU kernel. The CUDA kernel runs one thread per sample, on the
global sample index. Each flat model has its own library, built side by
side: `csrc/abc_sim_<model>.cu` (`library`); SIARD's also holds the RNG
test entries. A regional model (`model.is_regional`) runs the region axis
from the library of its struct, `csrc/abc_sim_regional_<kernel>.cu`, chosen
by `model.kernel` and not by its name (`regionalize` renames a spec
`seir_r3`). Two entries share each kernel's body:

* "distance" (theta in, C name `abc_sim_distance_<struct>`) takes

    theta_soa  [W, B] f32, contiguous: parameters as structure of arrays
    obs        [n_chan, T] f32, contiguous: the lowered observed summary
    fconst     host f32 [N_FCONST]: population, a0, r0, d0, mean scale,
               then MAX_CHAN channel weights
    iconst     host i32 [N_ICONST]: seed, the summary flags (cumulative,
               log1p, power, root, bin_days), then the intervention
               schedule (windows, scaled parameters, MAX_WINDOWS breakpoint
               days, each parameter's place among the scaled ones or -1)

  and writes one distance per sample;
* "wave" (the ABC wave, `abc_sim_wave_<struct>`) takes the uniform box (lows, highs)
  and a prior seed in place of theta, draws theta inside the kernel as
  `UniformBoxPrior.sample` does, and returns theta [B, W] row-major and the
  distances with NaN turned to +inf. Its `offset` makes sample b hash on
  offset + b (prior draw and noise) while it writes row b, so a wave of B
  rows at offset o is bitwise rows [o, o + B) of the offset-0 wave of o + B
  rows: a rank's slice of one logical wave (`core.distributed`'s pjit
  style). The theta-in entries take no offset.

The regional entries (`abc_sim_regional_<entry>_<struct>`) take the same
theta, box and host constants
(fconst's weight lanes unused) and, in device buffers made once per
simulator, the mobility matrix [R, R] (coupled models) and the channel
weights [n_chan]; R, the seeded region and the pooling are run-time
arguments. obs is [n_chan, T] with n_chan = R * n_observed, region-major,
or n_observed when pooled. The region axis has three routes in each
struct's library, all bitwise the plain version: "thread" (one thread a
sample, `csrc/abc_sim_regional.cuh`) and "warp" (one warp a sample, its
regions over the lanes, `csrc/abc_sim_regional_warp.cuh`, entries named
`..._warp_<struct>`), both up to `MAX_REGIONS`, and "tile" (a tile of
`TILE_SAMPLES` samples a block, the matrix streamed through shared memory,
`csrc/abc_sim_regional_tile.cuh`, entries `..._tile_<struct>`) up to
`TILE_MAX_REGIONS`. The tile route also takes what the other two do not:
inflow and outflow rows, a population a region, a spec's `coupled_inputs`
and `region_constants` (li2020's library holds it alone). It reads the
matrix transposed and padded, the populations and the region constants
from device buffers (`tile_buffers`, made once a simulator and required
on that route) and keeps its samples' state in scratch allocated a launch:
a slot a block in flight, as many blocks as the occupancy query finds
resident on each SM times the card's SMs (`Launch.slots`), so that two or
more tiles share an SM where the kernel's registers and shared memory let
them (not for li2020 at 375 cities: one). `regional_route` picks a route
from R, the struct and the launch's batch. There is no fallback: a launch
error of the chosen route raises.

`launch(model, entry, batch, ...)` is the one way to the C entries: it
checks the fixed inputs, picks the route (`route=` holds one against
another), resolves and types the C function and, on the tile route, makes
the occupancy query, once, and returns a `Launch` whose calls take only
what changes from launch to launch (the seeds, theta or the box, the gate,
the output buffers, the offset). `ops.AbcSim` keeps one a (entry, batch).

Every entry takes a `gate`: None, or an int32 tensor of shape [1] on the
launch's device. A launch whose gate reads 0 when the kernel runs writes
nothing, so that a loop can enqueue waves past its target without waiting
for the count (`core.abc`'s device wave loop). The wave entries also take
`out=(theta, dist)`, and the theta-in entries `out=dist`: buffers that a
loop reuses from wave to wave.

W is the model's P parameters plus a schedule's scale columns
(`spec.InterventionSchedule`), P without one. The constants, the schedule,
the box and the seeds travel in the kernel's parameters, not in device
memory, so a new breakpoint day or schedule needs no new build. The summary
flags pick one of the kernel's compiled variants on the host, so one build
serves every flat (summary, distance) pair. The TPU rules of 128 lanes and 8 sublanes do not carry over: a block
size in threads replaces the tile, and distances are bitwise the same for
every block size.

`ENTRY_LAUNCHES` counts the launches of each exported entry by its C name
(`abc_sim_wave_seiard`, `abc_sim_regional_wave_metapop_seir`, ...),
`launches(entry)` those of one entry summed over the models, flat and
regional. Of those, `ENTRY_GATED` counts the launches whose gate read 0 (a
loop records them once it has read its count, `record_gated`), so that
`gated_launches(entry)` and `run_launches(entry)` split `launches(entry)`.
`route_counts()` sums both by route ("flat", "thread", "warp", "tile";
`entry_route`).
`RNG_LAUNCHES` counts the launches of the two test entries:
`rng_normals`, which writes the kernel's hash bits or normals for (seed,
sample, counter), and `unit_math_mismatches`, which holds the kernel's
branch-free Box-Muller pieces to logf, sqrtf and cosf on every uniform the
hash can give.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.summaries import (
    FLAG_BIN_DAYS,
    FLAG_CUMULATIVE,
    FLAG_LOG1P,
    FLAG_POWER,
    FLAG_ROOT,
    LoweredSummary,
    num_bins,
)
from repro_torch.epi.spec import MAX_WINDOWS, CompartmentalModel, active_schedule
from repro_torch.kernels import build
from repro_torch.kernels.rng import check_offset

#: host constant layout (checked against the library at load)
MAX_CHAN = 8
MAX_PARAMS = 16
N_FCONST = 5 + MAX_CHAN
#: iconst lanes: seed, 5 summary flags, then the schedule
I_N_WINDOWS, I_N_TV, I_BREAKPOINTS = 6, 7, 8
I_TV_SLOT = I_BREAKPOINTS + MAX_WINDOWS
N_ICONST = I_TV_SLOT + MAX_PARAMS
#: the kernel's __launch_bounds__
MAX_BLOCK = 256
DEFAULT_BLOCK = 256
#: the most regions the thread and warp routes take (the thread route's
#: local arrays, the warp route's 4 regions a lane); the tile route takes up
#: to TILE_MAX_REGIONS
MAX_REGIONS = 128
#: the warp route's __launch_bounds__ (128 registers a thread) and its block,
#: in threads (block / 32 samples a block): the fastest of 128, 256, 384 and
#: 512 at R = 100 (experiments/abc_sim_regional_routes.py, PERF.md)
WARP_MAX_BLOCK = 512
WARP_DEFAULT_BLOCK = 512
#: R from which `regional_route` takes the warp route, by batch: (least
#: batch, least R) pairs, batch ascending. Each R is the crossover of both
#: routes timed in turns at that batch x 49 days (20,000, 50,000 and 100,000;
#: 1,000,000 keeps 100,000's); a batch between two takes the lower one's.
#: The thread route gains more from a larger batch (at 20,000 its 79 blocks
#: leave SMs idle), so the crossover rises with the batch
#: (experiments/abc_sim_regional_routes.py, PERF.md).
WARP_MIN_REGIONS = ((0, 12), (50_000, 18), (100_000, 24))
ROUTES = ("thread", "warp", "tile")
#: the tile route: the most regions (its shared memory at 3 coupled
#: compartments and 2 observed), samples a block, matrix rows (sources) a
#: staged chunk, and the regions a warp's lanes cover (R is padded to it)
TILE_MAX_REGIONS = 512
TILE_SAMPLES = 16
TILE_CHUNK = 16
TILE_RBLOCK = 128
#: shared memory a block may opt in to on compute capability 9.0
SMEM_OPTIN_BYTES = 232_448

#: launches of each exported entry, by C name (abc_sim_wave_siard, ...)
ENTRY_LAUNCHES: dict = {}
#: of those, the launches whose gate read 0 (they wrote nothing)
ENTRY_GATED: dict = {}
#: launches of the two RNG test entries
RNG_LAUNCHES = 0

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_typed: set = set()


def _spec(model) -> CompartmentalModel:
    if isinstance(model, str):
        from repro_torch.epi.models import get_model

        return get_model(model)
    return model


def library(model) -> str:
    """The csrc/ source (and library) that holds the kernel of `model` (a
    spec or a registered name): `abc_sim_<kernel>` for a flat model,
    `abc_sim_regional_<kernel>` for a regional one, `kernel` being the
    spec's struct."""
    spec = _spec(model)
    return f"abc_sim_{'regional_' if spec.is_regional else ''}{spec.kernel}"


def struct_name(model) -> str:
    """The C++ struct of `model`'s rows: `metapop_seir` -> `MetapopSeir`."""
    return "".join(part.capitalize() for part in _spec(model).kernel.split("_"))


def warp_min_regions(batch: int) -> int:
    """The least R that takes the warp route at `batch` samples a launch."""
    return [r for b, r in WARP_MIN_REGIONS if batch >= b][-1]


def tile_only(model) -> bool:
    """Whether only the tile route takes `model`'s region axis: past
    MAX_REGIONS, or with what the thread and warp routes lack (inflow or
    outflow rows, a population a region, `coupled_inputs`,
    `region_constants`)."""
    spec = _spec(model)
    ends = any(s is None for s in spec.transition_sources + spec.transition_destinations)
    return (spec.n_regions > MAX_REGIONS or ends or spec.populations is not None
            or spec.coupled_inputs is not None or spec.region_constants is not None)


def regional_routes(model) -> tuple:
    """The routes `model`'s region axis takes at some batch, in `ROUTES`
    order."""
    spec = _spec(model)
    if not spec.is_regional:
        raise ValueError(f"{spec.name} is flat; it has no region axis")
    if tile_only(spec):
        return ("tile",)
    least = [r for _, r in WARP_MIN_REGIONS]
    return tuple(r for r, on in (("thread", spec.n_regions < max(least)),
                                 ("warp", spec.n_regions >= min(least))) if on)


def regional_route(model, batch: Optional[int] = None) -> str:
    """The route of `model`'s region axis at `batch` samples a launch: "tile"
    where only it takes the model (`tile_only`), else "warp" (one warp a
    sample) from `warp_min_regions(batch)` regions on, else "thread" (one
    thread a sample). With no batch, the one route that R takes at every
    batch; a ValueError where the route depends on it."""
    spec = _spec(model)
    routes = regional_routes(spec)
    if batch is not None and routes != ("tile",):
        return "warp" if spec.n_regions >= warp_min_regions(int(batch)) else "thread"
    if len(routes) > 1:
        raise ValueError(f"{spec.name} takes the thread or the warp route by batch "
                         f"(WARP_MIN_REGIONS = {WARP_MIN_REGIONS}); give the batch or the "
                         "route")
    return routes[0]


def _route(model: CompartmentalModel, route: Optional[str],
           batch: Optional[int] = None) -> str:
    """`route`, checked, or `regional_route(model, batch)` where it is None."""
    if route is None:
        return regional_route(model, batch)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return route


def route_block(route: str, block: Optional[int] = None) -> int:
    """`block`, checked against the route's launch bound, or the route's
    default where it is None ("thread" also stands for the flat kernel).
    The tile route launches its struct's own block (a warp a group of four
    coupled columns, `csrc/abc_sim_regional_tile.cuh`) and leaves `block`
    unused; it is checked as the thread route's."""
    limit = WARP_MAX_BLOCK if route == "warp" else MAX_BLOCK
    if block is None:
        return WARP_DEFAULT_BLOCK if route == "warp" else DEFAULT_BLOCK
    return check_block(block, limit)


def check_kernel_block(model, block: Optional[int] = None) -> None:
    """Raise unless `block` (threads; None: each kernel's default) is within
    the launch bound of every kernel `model` may run: the flat one, or each
    of `regional_routes`."""
    spec = _spec(model)
    for route in regional_routes(spec) if spec.is_regional else ("thread",):
        route_block(route, block)


def entry_name(model, entry: str, route: Optional[str] = None) -> str:
    """The C name of `model`'s `entry` ("distance" or "wave"):
    `abc_sim_wave_siard`, `abc_sim_regional_wave_metapop_seir`, and on the
    warp route (`route`, or `regional_route` where it is None)
    `abc_sim_regional_wave_warp_metapop_seir`."""
    spec = _spec(model)
    if not spec.is_regional:
        return f"abc_sim_{entry}_{spec.kernel}"
    route = _route(spec, route)
    infix = "" if route == "thread" else f"{route}_"
    return f"abc_sim_regional_{entry}_{infix}{spec.kernel}"


def entry_route(name: str) -> str:
    """The route of a C entry name: "tile", "warp", "thread" (regional) or
    "flat"."""
    if not name.startswith("abc_sim_regional_"):
        return "flat"
    for route in ("tile", "warp"):
        if f"_{route}_" in name:
            return route
    return "thread"


def tile_rpad(n_regions: int) -> int:
    """R rounded up to `TILE_RBLOCK`: the tile route's padded region axis."""
    return -(-int(n_regions) // TILE_RBLOCK) * TILE_RBLOCK


#: the library that also holds the RNG test entries
RNG_LIBRARY = "abc_sim_siard"


def _lib(name: str = RNG_LIBRARY) -> ctypes.CDLL:
    """The library `name`, its constant layout checked at first load."""
    lib = build.load(name)
    if name not in _typed:
        names = ("abc_sim_n_fconst", "abc_sim_n_iconst", "abc_sim_max_chan",
                 "abc_sim_max_block")
        for fn in names:
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        layout = tuple(getattr(lib, fn)() for fn in names)
        if layout != (N_FCONST, N_ICONST, MAX_CHAN, MAX_BLOCK):
            raise RuntimeError(
                f"{name} library constant layout {layout} does not match the "
                f"wrapper's {(N_FCONST, N_ICONST, MAX_CHAN, MAX_BLOCK)}"
            )
        if name.startswith("abc_sim_regional_"):
            # the warp route's symbols are missing where a library holds the
            # tile route alone (li2020's)
            checks = (("abc_sim_max_regions", MAX_REGIONS, True),
                      ("abc_sim_warp_max_block", WARP_MAX_BLOCK, False),
                      ("abc_sim_tile_max_regions", TILE_MAX_REGIONS, True),
                      ("abc_sim_tile_samples", TILE_SAMPLES, True))
            for fn, want, required in checks:
                if not required and not hasattr(lib, fn):
                    continue
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = ctypes.c_int
                if getattr(lib, fn)() != want:
                    raise RuntimeError(f"{name}'s {fn}() is {getattr(lib, fn)()}, the "
                                       f"wrapper's {want}")
        if name == RNG_LIBRARY:
            lib.rng_normals.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, _VP, ctypes.c_int, _VP]
            lib.rng_normals.restype = ctypes.c_int
            lib.unit_math_mismatches.argtypes = [_VP, _VP]
            lib.unit_math_mismatches.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _typed.add(name)
    return lib


def _check_struct(lib: ctypes.CDLL, model: CompartmentalModel) -> None:
    """Raise unless the struct in `lib` has the spec's sizes, coupled
    compartments, region constants (as many as the spec's hook makes),
    coupled inputs of its own where the spec has them, and each
    transition's source and destination."""
    out = _struct_shape(lib, model.kernel)
    n_coupled, n_trans = int(out[4]), int(out[1])
    more = [int(v) for v in out[5 + n_coupled:7 + n_coupled + 2 * n_trans]]
    got = (tuple(int(v) for v in out[:4]), tuple(int(v) for v in out[5:5 + n_coupled]),
           bool(more[1]), tuple(v if v >= 0 else None for v in more[2::2]),
           tuple(v if v >= 0 else None for v in more[3::2]))
    want = ((model.n_state, model.n_transitions, model.n_params, model.n_observed),
            model.coupled_idx, model.coupled_inputs is not None, model.transition_sources,
            model.transition_destinations)
    if got != want:
        raise ValueError(f"the struct of {library(model)} has (state, transitions, params, "
                         f"observed), coupled, own coupled inputs, sources, destinations "
                         f"{got}; {model.name} declares {want}")


def _struct_shape(lib: ctypes.CDLL, kernel: str) -> np.ndarray:
    """What `abc_sim_regional_shape_<kernel>` reports of the struct: N_STATE,
    N_TRANS, N_PARAMS, N_OBS, N_COUPLED, the coupled compartments,
    N_RCONST, whether it makes its coupled inputs, then each transition's
    source and destination (-1: none)."""
    shape_fn = getattr(lib, f"abc_sim_regional_shape_{kernel}")
    shape_fn.argtypes = [_VP]
    shape_fn.restype = _INT
    out = np.zeros((64,), np.int32)
    shape_fn(out.ctypes.data)
    return out


def variant(flags, wave: bool) -> int:
    """The kernel variant (`csrc/abc_sim.cuh`) that the summary flags and the
    entry select: bits CUM 1, LOG1P 2, L1 4, WAVE 8."""
    return (int(flags[FLAG_CUMULATIVE]) == 1) | 2 * (int(flags[FLAG_LOG1P]) == 1) \
        | 4 * (int(flags[FLAG_POWER]) == 1) | 8 * bool(wave)


def variant_symbol(model: CompartmentalModel, v: int, route: Optional[str] = None) -> str:
    """The part of the mangled name that picks variant `v` of `model`'s
    kernel out of its library's SASS or ptxas report: `abc_sim_kernel<Siard,
    8>` is `abc_sim_kernelI5SiardLi8EE`, `abc_sim_kernel<Seiard, 8>`
    `abc_sim_kernelI6SeiardLi8EE`, and for a regional model
    `abc_sim_regional_kernel<MetapopSeir, 8>`
    `abc_sim_regional_kernelI11MetapopSeirLi8EE` on the thread route,
    `abc_sim_regional_warp_kernelI11MetapopSeirLi8EE` on the warp route and
    `abc_sim_regional_tile_kernelI11MetapopSeirLi8EE` on the tile route
    (`route`, or `regional_route` where it is None)."""
    struct = struct_name(model)
    if not model.is_regional:
        kernel = "abc_sim_kernel"
    else:
        route = _route(model, route)
        kernel = ("abc_sim_regional_kernel" if route == "thread"
                  else f"abc_sim_regional_{route}_kernel")
    return f"{kernel}I{len(struct)}{struct}Li{int(v)}EE"


def kernel_symbol(model: CompartmentalModel, flags, wave: bool,
                  route: Optional[str] = None) -> str:
    """`variant_symbol` of the variant that the summary flags and the entry
    select."""
    return variant_symbol(model, variant(flags, wave), route)


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")


def check_block(block: int, limit: int = MAX_BLOCK) -> int:
    """A block size in threads: a positive multiple of 32, at most `limit`
    (the fused kernel's launch bound)."""
    block = int(block)
    if block < 32 or block > limit or block % 32:
        raise ValueError(
            f"block={block} must be a multiple of 32 threads in [32, {limit}]"
        )
    return block


def theta_to_soa(theta) -> torch.Tensor:
    """[B, P] tensor or array -> contiguous float32 [P, B] (structure of
    arrays), on the tensor's device."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    if theta.ndim != 2:
        raise ValueError(f"theta must be [B, P], got shape {tuple(theta.shape)}")
    return theta.t().contiguous()


def pack_consts(
    *,
    population: float,
    a0: float,
    r0: float,
    d0: float,
    mean_scale: float,
    weights,
    flags,
    seed: int,
    model: CompartmentalModel | None = None,
    schedule=None,
):
    """Host constant arrays (fconst f32 [N_FCONST], iconst i32 [N_ICONST]);
    with a `schedule` (which needs its `model`) its lanes are filled."""
    w = np.asarray(weights, np.float32).reshape(-1)
    if w.size > MAX_CHAN:
        raise ValueError(f"{w.size} summary channels exceed the kernel's {MAX_CHAN}")
    if len(flags) != I_N_WINDOWS - 1:
        raise ValueError(f"expected {I_N_WINDOWS - 1} summary flags, got {len(flags)}")
    if (flags[FLAG_POWER], flags[FLAG_ROOT]) not in ((2, 1), (1, 0)):
        raise ValueError(
            f"summary flags {tuple(flags)}: the kernel is compiled for (power, root) "
            "(2, 1) and (1, 0), the two distance families"
        )
    fconst = np.zeros((N_FCONST,), np.float32)
    fconst[:5] = (population, a0, r0, d0, mean_scale)
    fconst[5:5 + w.size] = w
    iconst = np.zeros((N_ICONST,), np.int32)
    iconst[1:I_N_WINDOWS] = np.asarray(flags, np.int32)
    iconst[I_TV_SLOT:] = -1
    schedule = active_schedule(schedule)
    if schedule is not None:
        if model is None:
            raise ValueError("packing a schedule needs its model")
        shape = schedule.shape(model)
        iconst[I_N_WINDOWS], iconst[I_N_TV] = shape.n_windows, shape.n_tv
        iconst[I_BREAKPOINTS:I_BREAKPOINTS + shape.n_windows] = schedule.breakpoints
        for slot, j in enumerate(shape.tv_indices):
            iconst[I_TV_SLOT + j] = slot
    return fconst, with_seed(iconst, seed)


def theta_width(model: CompartmentalModel, iconst: np.ndarray) -> int:
    """W: the model's parameters plus the scale columns of the schedule
    packed into `iconst`."""
    return model.n_params + int(iconst[I_N_WINDOWS]) * int(iconst[I_N_TV])


def with_seed(iconst: np.ndarray, seed: int) -> np.ndarray:
    """A copy of `iconst` whose seed word is the uint32 `seed`."""
    iconst = iconst.copy()
    iconst[0] = np.uint32(int(seed) & 0xFFFFFFFF).view(np.int32)
    return iconst


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_cuda(name: str, t) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{t.device if isinstance(t, torch.Tensor) else type(t).__name__}")


def _check_2d_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 2-D float32 tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _entry_sum(counts: dict, entry: str) -> int:
    return sum(n for name, n in counts.items()
               if name.startswith((f"abc_sim_{entry}_", f"abc_sim_regional_{entry}_")))


def launches(entry: str) -> int:
    """Launches of `entry` ("distance", the theta-in entry, or "wave") of
    every model, flat and regional, from `ENTRY_LAUNCHES`."""
    return _entry_sum(ENTRY_LAUNCHES, entry)


def gated_launches(entry: str) -> int:
    """Those of `launches(entry)` whose gate read 0, from `ENTRY_GATED`."""
    return _entry_sum(ENTRY_GATED, entry)


def run_launches(entry: str) -> int:
    """Those of `launches(entry)` that ran: all but the gated ones."""
    return launches(entry) - gated_launches(entry)


def record_gated(name: str, n: int) -> None:
    """Record `n` launches of the C entry `name` whose gate read 0."""
    if n:
        ENTRY_GATED[name] = ENTRY_GATED.get(name, 0) + int(n)


def route_counts() -> Tuple[dict, dict]:
    """(launches, gated launches) by route ("flat", "thread", "warp",
    "tile"): `ENTRY_LAUNCHES` and `ENTRY_GATED` summed by `entry_route`."""
    def by_route(counts: dict) -> dict:
        out: dict = {}
        for name, n in counts.items():
            out[entry_route(name)] = out.get(entry_route(name), 0) + n
        return out

    return by_route(ENTRY_LAUNCHES), by_route(ENTRY_GATED)


def check_gate(gate: Optional[torch.Tensor], device: torch.device) -> None:
    """Raise unless `gate` is None or an int32 tensor of shape [1] on
    `device`: a launch reads it on the card, and a loop never waits for it."""
    if gate is None:
        return
    if (not isinstance(gate, torch.Tensor) or gate.dtype != torch.int32
            or tuple(gate.shape) != (1,) or gate.device != torch.device(device)):
        what = (f"{gate.dtype} {tuple(gate.shape)} on {gate.device}"
                if isinstance(gate, torch.Tensor) else type(gate).__name__)
        raise ValueError(f"gate must be an int32 tensor of shape [1] on {device}, got {what}")


def _out_tensor(name: str, t, shape: tuple, device: torch.device) -> torch.Tensor:
    """`t`, checked, or a new float32 tensor of `shape` where it is None."""
    if t is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or tuple(t.shape) != shape or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name} must be a contiguous float32 {list(shape)} tensor on {device}")
    return t


def wave_out(out, batch: int, width: int, device: torch.device):
    """(theta [batch, width], dist [batch]) to write: `out`, checked, or two
    new tensors."""
    theta, dist = (None, None) if out is None else out
    return (_out_tensor("out's theta", theta, (batch, width), device),
            _out_tensor("out's dist", dist, (batch,), device))


def _check_consts(fconst, iconst, model: CompartmentalModel) -> None:
    if fconst.dtype != np.float32 or fconst.shape != (N_FCONST,):
        raise ValueError(f"fconst must be float32 [{N_FCONST}]")
    if iconst.dtype != np.int32 or iconst.shape != (N_ICONST,):
        raise ValueError(f"iconst must be int32 [{N_ICONST}]")
    if model.n_params > MAX_PARAMS:
        raise ValueError(f"{model.name} has {model.n_params} parameters; the kernel "
                         f"takes at most {MAX_PARAMS}")


def _box(lows, highs, width: int, model: CompartmentalModel):
    """The box's bounds as contiguous float32 host arrays of `width`."""
    lo = np.ascontiguousarray(np.asarray(lows, np.float32).reshape(-1))
    hi = np.ascontiguousarray(np.asarray(highs, np.float32).reshape(-1))
    if lo.shape != (width,) or hi.shape != (width,):
        raise ValueError(
            f"the box has {lo.size} lows and {hi.size} highs; {model.name} with the "
            f"packed schedule has {width} columns"
        )
    return lo, hi


def regional_channels(model: CompartmentalModel, pool: int) -> int:
    """Summary channels of a regional launch: n_observed pooled over the
    regions (`pool` > 1), else R * n_observed."""
    return model.n_observed if pool > 1 else model.total_observed


def regional_smem_bytes(model: CompartmentalModel, pool: int, num_days: int,
                        route: Optional[str] = None, block: Optional[int] = None) -> int:
    """Shared memory of a regional block: the observed summary and the
    weights, and for a coupled model the mobility matrix; on the warp route
    (`block` threads, block / 32 warps) the matrix in groups of four sources
    (ceil(R / 4) * 4 * R floats and 128 of padding) and each warp's vectors,
    (N_COUPLED + N_OBS) * MAX_REGIONS floats. On the tile route: the coupled
    inputs and rows [Rpad][N_COUPLED * TILE_SAMPLES] and two matrix chunks
    [TILE_CHUNK][Rpad] (coupled models), the channel values [R * N_OBS]
    [TILE_SAMPLES] and the tile's parameters, whatever the days."""
    n_chan = regional_channels(model, pool)
    route = _route(model, route)
    if route == "tile":
        rpad, nc = tile_rpad(model.n_regions), len(model.coupled)
        coupled = rpad * nc * TILE_SAMPLES + 2 * TILE_CHUNK * rpad if nc else 0
        return 4 * (coupled + (model.total_observed + model.n_params) * TILE_SAMPLES)
    if route == "thread":
        mob = model.n_regions ** 2 if model.coupled else 0
        return 4 * (n_chan * (num_days + 1) + mob)
    warps = route_block(route, block) // 32
    per_warp = (len(model.coupled) + model.n_observed) * MAX_REGIONS
    groups = -(-model.n_regions // 4)
    mob4 = 4 * groups * model.n_regions + 128 if model.coupled else 0
    return 4 * (warps * per_warp + mob4 + n_chan * (num_days + 1))


def check_regional(model: CompartmentalModel, obs: torch.Tensor, mobility, weights,
                   pool: int, route: Optional[str] = None, block: Optional[int] = None) -> None:
    """Raise unless the region axis of `model` fits the kernel of `route`
    (each of `regional_routes` where it is None) at `block` and the device buffers
    are what it reads: R at most MAX_REGIONS (TILE_MAX_REGIONS on the tile
    route), obs [n_chan, T], weights [n_chan], mobility [R, R] (coupled
    models), the block's shared memory within the opt-in limit."""
    R = model.n_regions
    if not model.is_regional:
        raise ValueError(f"{model.name} is flat; it has no region axis")
    routes = regional_routes(model) if route is None else (_route(model, route),)
    for name in routes:
        label, most = (("TILE_MAX_REGIONS", TILE_MAX_REGIONS) if name == "tile"
                       else ("MAX_REGIONS", MAX_REGIONS))
        if R > most:
            raise ValueError(f"{model.name} has {R} regions; the {name} route of the regional "
                             f"kernel takes at most {label} = {most}")
    if route is not None and route != "tile" and tile_only(model):
        raise ValueError(f"{model.name} runs on the tile route alone (`tile_only`), not the "
                         f"{route} route")
    n_chan = regional_channels(model, pool)
    if obs.shape[0] != n_chan or obs.shape[1] < 1:
        raise ValueError(f"obs must be [{n_chan}, T>=1] for {model.name} (pool {pool}), "
                         f"got {tuple(obs.shape)}")
    for name, t, shape in (("weights", weights, (n_chan,)), ("mobility", mobility, (R, R))):
        if name == "mobility" and not model.coupled:
            continue
        if (not isinstance(t, torch.Tensor) or t.device != obs.device
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {list(shape)} tensor on "
                             f"{obs.device}")
    for route in routes:
        smem = regional_smem_bytes(model, pool, obs.shape[1], route, block)
        if smem > SMEM_OPTIN_BYTES:
            raise ValueError(f"{model.name} at {obs.shape[1]} days needs {smem} bytes of "
                             f"shared memory a block on the {route} route; the card gives at "
                             f"most {SMEM_OPTIN_BYTES}")


class TileBuffers(NamedTuple):
    """What the tile route reads beside the other routes' buffers, made once
    a simulator (`tile_buffers`): the matrix transposed and zero-padded,
    mob_t [Rpad, Rpad] with mob_t[q][r] = mobility[r][q] (None for a model
    with nothing coupled), the region populations [R] and the region
    constants [N_RCONST, R] (None without them), float32 on one card, and
    the floats of scratch a block takes (the library's
    `abc_sim_regional_tile_slot_floats_<struct>(R)`)."""

    mob_t: Optional[torch.Tensor]
    pops: torch.Tensor
    rconst: Optional[torch.Tensor]
    slot_floats: int


def tile_buffers(model: CompartmentalModel, mobility: Optional[torch.Tensor],
                 population: float, device) -> TileBuffers:
    """The tile route's buffers of `model` on `device`, from its [R, R]
    float32 matrix there (None with nothing coupled): the populations as
    the plain version forms them
    (`engine.region_population`: the spec's own, or population / R in
    float32) and the spec's `region_constants` of the float32 matrix and
    those populations, as many rows as the struct reads."""
    from repro_torch.epi import engine

    R = model.n_regions
    like = torch.empty((0,), device=device)
    pops = engine.region_population(model, population, like)
    pops = torch.broadcast_to(pops, (R,)).contiguous()
    mob_t = None
    if model.coupled:
        rpad = tile_rpad(R)
        mob_t = torch.zeros((rpad, rpad), dtype=torch.float32, device=device)
        mob_t[:R, :R] = mobility.t()
    rows = engine.region_constants(model, mobility, pops) if mobility is not None else ()
    rconst = torch.stack([r.to(torch.float32) for r in rows]).contiguous() if rows else None
    lib = _lib(library(model))
    shape = _struct_shape(lib, model.kernel)
    if len(rows) != int(shape[5 + shape[4]]):
        raise ValueError(f"{model.name}'s region_constants make {len(rows)} rows; its struct "
                         f"reads {int(shape[5 + shape[4]])}")
    slot_floats = getattr(lib, f"abc_sim_regional_tile_slot_floats_{model.kernel}")
    slot_floats.argtypes = [_INT]
    slot_floats.restype = ctypes.c_longlong
    return TileBuffers(mob_t, pops, rconst, int(slot_floats(R)))


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _tile_resident(lib: ctypes.CDLL, kernel: str, n_regions: int, v: int,
                   device: torch.device) -> int:
    """Blocks of variant `v` of the tile kernel of struct `kernel` in `lib`
    resident on each SM of `device` at `n_regions` regions: the occupancy
    query at the kernel's registers and shared memory
    (`abc_sim_regional_tile_resident_<struct>`)."""
    fn = getattr(lib, f"abc_sim_regional_tile_resident_{kernel}")
    fn.argtypes = [_INT, _INT]
    fn.restype = _INT
    with torch.cuda.device(device):
        blocks = fn(int(n_regions), int(v))
    if blocks < 0:
        _check_rc(lib, -blocks, f"the occupancy query of the tile kernel of {kernel}")
    if blocks < 1:
        raise RuntimeError(f"the tile kernel of {kernel} at {n_regions} regions fits no SM")
    return blocks


def launch(model: CompartmentalModel, entry: str, batch: int, *, obs: torch.Tensor,
           fconst: np.ndarray, iconst: np.ndarray, weights: Optional[torch.Tensor] = None,
           mobility: Optional[torch.Tensor] = None, tile: Optional[TileBuffers] = None,
           pool: int = 1, block: Optional[int] = None, route: Optional[str] = None) -> "Launch":
    """The launch of `model`'s `entry` ("distance", theta in, or "wave") at
    `batch` samples against the lowered summary `obs` [n_chan, T] and the
    host constants (`pack_consts`; iconst's seed word is set by each call),
    checked and bound once. A regional model also takes its device buffers:
    `weights` [n_chan], `mobility` [R, R] (coupled models), `tile`
    (`tile_buffers`, read on the tile route alone), its `pool` factor
    (`summaries.pool_factor`) and `route` (None: `regional_route` at
    `batch`). `block` is in threads (None: the route's default). Raises on
    what no call could launch; what a call changes (seeds, theta or the
    box, gate, out, offset) is checked by the call."""
    if entry not in ("distance", "wave"):
        raise ValueError(f"entry must be 'distance' or 'wave', got {entry!r}")
    batch = int(batch)
    if batch < 1:
        raise ValueError(f"a launch needs at least one sample, got batch={batch}")
    _check_cuda("obs", obs)
    _check_2d_f32("obs", obs)
    _check_consts(fconst, iconst, model)
    regional = model.is_regional
    if regional:
        route = _route(model, route, batch)
        block = route_block(route, block)
        check_regional(model, obs, mobility, weights, pool, route, block)
    else:
        route, block = "flat", route_block("thread", block)
        if obs.shape[0] != model.n_observed or obs.shape[1] < 1:
            raise ValueError(f"obs must be [{model.n_observed}, T>=1], got {tuple(obs.shape)}")
    wave, dev = entry == "wave", obs.device
    lib = _lib(library(model))
    name = entry_name(model, entry, route if regional else None)
    fn = getattr(lib, name, None)
    if fn is None:
        raise NotImplementedError(
            f"no CUDA kernel for model {model.name!r} (missing C symbol {name} in "
            f"csrc/{library(model)}.cu); the kernel carries the structs of siard, sir, "
            "seir, seiard, metapop_seir and li2020")
    resident = slots = slot_floats = None
    if route == "tile":
        if tile is None:
            raise ValueError(f"the tile route of {model.name} reads its buffers from "
                             "`tile_buffers`; pass tile=")
        for t in (tile.mob_t, tile.pops, tile.rconst):
            if t is not None and (t.device != dev or t.dtype != torch.float32
                                  or not t.is_contiguous()):
                raise ValueError(f"the tile route's buffers must be contiguous float32 tensors "
                                 f"on {dev}")
        inputs = (obs, tile.mob_t, tile.pops, tile.rconst, weights)
        # the occupancy query of the launch's own variant: the flags follow the seed
        v = variant(iconst[1:I_N_WINDOWS], wave)
        resident = _tile_resident(lib, model.kernel, model.n_regions, v, dev)
        slots = min(-(-batch // TILE_SAMPLES), resident * _sm_count(dev))
        slot_floats = tile.slot_floats
    elif regional:
        inputs = (obs, mobility if model.coupled else None, weights)
    else:
        inputs = (obs,)
    sizes = (batch, obs.shape[1])
    if regional:
        sizes += (model.n_regions, model.seed_region, int(pool > 1))
        _check_struct(lib, model)
    if route != "tile":
        sizes += (block,)
    # the C arguments: theta, or the prior seed and the box; the device
    # inputs (the tile route's scratch and its slots); theta and dist, or
    # dist; the constants, the sizes, the stream, the gate (the offset)
    fn.argtypes = ([ctypes.c_uint, _VP, _VP] if wave else [_VP]) + [_VP] * len(inputs) \
        + ([_VP, _INT] if route == "tile" else []) + [_VP] * (1 + wave) + [_VP, _VP] \
        + [_INT] * len(sizes) + [_VP, _VP] + ([ctypes.c_uint] if wave else [])
    fn.restype = _INT
    return Launch(model, entry, name, route, block, fn, lib, inputs, sizes,
                  np.ascontiguousarray(fconst), np.ascontiguousarray(iconst),
                  theta_width(model, iconst), resident, slots, slot_floats)


class Launch:
    """One entry of one simulator at one batch, made by `launch`: the C
    function with its arguments typed, its fixed inputs and sizes bound.
    `name` is the C entry (the `ENTRY_LAUNCHES` key), `route` "flat",
    "thread", "warp" or "tile", `block` the threads a block (unused on the
    tile route), and on the tile route `resident` (blocks of the kernel the
    occupancy query finds on each SM) and `slots` (scratch slots a launch:
    min(tiles, resident x SMs), so that two or more tiles share an SM where
    the kernel's registers and shared memory let them).

    `launch(seed, theta_soa)` (theta in) returns distances [B];
    `launch(seed, prior_seed, lows, highs, offset=o)` (the wave) returns
    theta [B, W] drawn from U(lows, highs) as `UniformBoxPrior.sample(
    prior_seed, B, offset=o)` does and its distances with NaN turned to
    +inf. `seed` is the simulation seed; `gate` and `out` as the module
    says. Each call launches on the current stream (the tile route's
    scratch allocated for it), raises where the launch fails and counts one
    in `ENTRY_LAUNCHES[name]`."""

    def __init__(self, model, entry, name, route, block, fn, lib, inputs, sizes, fconst, iconst,
                 width, resident, slots, slot_floats):
        self.model, self.entry, self.name, self.route, self.block = model, entry, name, route, block
        self.fn, self._lib, self.width = fn, lib, width
        self.resident, self.slots, self._slot_floats = resident, slots, slot_floats
        self.batch, self.device = sizes[0], inputs[0].device
        self._keep = (inputs, fconst)  # the buffers behind the pointers
        self._inputs = tuple(None if t is None else t.data_ptr() for t in inputs)
        self._sizes, self._fconst, self._iconst = sizes, fconst.ctypes.data, iconst

    def __call__(self, seed: int, *head, gate: Optional[torch.Tensor] = None, out=None,
                 offset: int = 0):
        device, batch = self.device, self.batch
        check_gate(gate, device)
        if self.entry == "wave":
            prior_seed, lows, highs = head
            lo, hi = _box(lows, highs, self.width, self.model)
            offset = check_offset(offset, batch)
            result = theta, dist = wave_out(out, batch, self.width, device)
            if theta.data_ptr() % 16:
                raise RuntimeError("theta's storage is not 16-byte aligned")
            first = (int(prior_seed) & 0xFFFFFFFF, lo.ctypes.data, hi.ctypes.data)
            outs, last = (theta.data_ptr(), dist.data_ptr()), (offset,)
        else:
            (theta_soa,) = head
            if not isinstance(theta_soa, torch.Tensor) or theta_soa.device != device:
                raise ValueError(f"theta_soa must be a CUDA tensor on {device}, got "
                                 f"{getattr(theta_soa, 'device', type(theta_soa).__name__)}")
            _check_2d_f32("theta_soa", theta_soa)
            if tuple(theta_soa.shape) != (self.width, batch):
                raise ValueError(f"theta_soa is {tuple(theta_soa.shape)}; this launch of "
                                 f"{self.model.name} takes [{self.width}, {batch}]")
            if offset:
                raise ValueError("the theta-in entry takes no offset")
            result = _out_tensor("out", out, (batch,), device)
            first, outs, last = (theta_soa.data_ptr(),), (result.data_ptr(),), ()
        iconst = with_seed(self._iconst, seed)
        scratch = ()
        if self.slots is not None:
            buf = torch.empty((self.slots * self._slot_floats,), dtype=torch.float32,
                              device=device)
            scratch = (buf.data_ptr(), self.slots)
        with torch.cuda.device(device):
            rc = self.fn(*first, *self._inputs, *scratch, *outs, self._fconst,
                         iconst.ctypes.data, *self._sizes, _stream_handle(device),
                         None if gate is None else gate.data_ptr(), *last)
        _check_rc(self._lib, rc, self.name)
        ENTRY_LAUNCHES[self.name] = ENTRY_LAUNCHES.get(self.name, 0) + 1
        return result


def rng_normals(
    seed: int,
    batch: int,
    n_ctr: int,
    *,
    bits: bool = False,
    device="cuda",
    block: int = 256,
) -> torch.Tensor:
    """[batch, n_ctr] from the kernel's own RNG: `normal(seed, b, c)` as
    float32, or with `bits` the uint32 `hash_u32(seed, b, c)` as int64."""
    global RNG_LAUNCHES
    block = check_block(block, 1024)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"rng_normals runs on a CUDA device, got {device}")
    if batch < 1 or n_ctr < 1:
        raise ValueError("batch and n_ctr must be positive")
    lib = _lib()
    dtype = torch.int32 if bits else torch.float32
    out = torch.empty((batch, n_ctr), dtype=dtype, device=device)
    with torch.cuda.device(device):
        rc = lib.rng_normals(int(seed) & 0xFFFFFFFF, batch, n_ctr, int(bits),
                             out.data_ptr(), block, _stream_handle(device))
    _check_rc(lib, rc, "rng_normals")
    RNG_LAUNCHES += 1
    return out.to(torch.int64) & 0xFFFFFFFF if bits else out


def unit_math_mismatches(device="cuda") -> tuple:
    """(u whose sqrt(-2 log u) differ, u whose cos(2 pi u) differ) between
    the kernel's branch-free Box-Muller pieces and the precise logf, sqrtf
    and cosf, over all 2^24 uniforms u = k * 2^-24 the hash can give: (0, 0)
    means the kernel's normals are those of the precise functions."""
    global RNG_LAUNCHES
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"unit_math_mismatches runs on a CUDA device, got {device}")
    lib = _lib()
    counts = torch.zeros((2,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.unit_math_mismatches(counts.data_ptr(), _stream_handle(device))
    _check_rc(lib, rc, "unit_math_mismatches")
    RNG_LAUNCHES += 1
    return tuple(int(c) for c in counts.cpu())


def tile_math_mismatches(device="cuda", pairs: int = 1 << 30) -> dict:
    """The branch-free pieces of li2020's tile route against the CUDA math
    they stand for, on the card (`abc_sim_li2020_math_mismatches`): the
    tau-leap's square root (`root_checked`) over all 2^32 float bit patterns
    and the struct's quotient (`div_checked`) over `pairs` hashed pairs,
    each where it takes its fast path. {"root": mismatches, "root_fast":
    patterns on the fast path, "div": mismatches, "div_fast": pairs on the
    fast path}; 0 mismatches means both are sqrtf and `/` bit for bit."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"tile_math_mismatches runs on a CUDA device, got {device}")
    lib = _lib("abc_sim_regional_li2020")
    fn = lib.abc_sim_li2020_math_mismatches
    fn.argtypes = [ctypes.c_ulonglong, _VP, _VP]
    fn.restype = _INT
    counts = torch.zeros((4,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = fn(int(pairs), counts.data_ptr(), _stream_handle(device))
    _check_rc(lib, rc, "abc_sim_li2020_math_mismatches")
    root, div, div_fast, root_fast = (int(c) for c in counts.cpu())
    return {"root": root, "root_fast": root_fast, "div": div, "div_fast": div_fast}


#: operations per transition and sample-day: two hashes of 18 (the counter
#: product as one add to a per-day base, the xor with the per-sample base,
#: two fmix32 of 8), two uniforms of 4 (shift, add, convert, scale),
#: Box-Muller 6 (log, 2 muls, sqrt, cos, mul), hazard clamp and tau-leap 5
#: (max, sqrt, mul, add, floor), drain 3 (max, min, sub), stoichiometry 2
TRANSITION_OPS = 2 * 18 + 2 * 4 + 6 + 5 + 3 + 2


def ops_per_sample_day(model: CompartmentalModel, lowered: LoweredSummary) -> float:
    """Operations the fused function needs per sample-day, for the bound.

    Work that depends on neither the day nor the transition is counted once
    per sample: the hash's `seed ^ idx * P1 ^ X1` (3) and the final sqrt.
    Per day and region: `TRANSITION_OPS` per transition, the model's
    `hazard_ops`, and the counter base (1). Per day, a coupled compartment's
    rows (a product and an add a source region, less the first add: R * (2R
    - 1)) and, pooled, the adds that sum each observed compartment over the
    regions (n_observed * (R - 1)). Per summary channel (R * n_observed, or
    n_observed pooled, as `lowered` holds them): the running carry each day
    (1 when cumulative or binned), and on each flush day the residual, its
    square or absolute value, the weight and the sum (4), plus clamp and
    log1p (2). The kernel's runtime selectors are its own overhead and are
    not counted; the model's per-sample work (initial state, parameter
    products) is left out. A transcendental counts as one operation. At
    R=1 the region terms vanish: the flat count.
    """
    flags = lowered.flags
    n_chan, num_days = lowered.obs_summary.shape
    R = model.n_regions
    bin_days = int(flags[FLAG_BIN_DAYS])
    n_flush = num_bins(num_days, bin_days)
    carry = 1 if int(flags[FLAG_CUMULATIVE]) == 1 or bin_days > 1 else 0
    flush_ops = 4 + 2 * (int(flags[FLAG_LOG1P]) == 1)
    per_sample = 3 + (int(flags[FLAG_ROOT]) == 1) + (lowered.mean_scale != 1.0)
    coupling = len(model.coupled) * R * (2 * R - 1) if model.is_regional else 0
    pooling = model.n_observed * (R - 1) if R > 1 and n_chan == model.n_observed else 0
    total = (num_days * (R * (TRANSITION_OPS * model.n_transitions + model.hazard_ops + 1)
                         + coupling + pooling + n_chan * carry)
             + n_chan * n_flush * flush_ops + per_sample)
    return total / num_days


#: operations of the wave entry's prior draw, per parameter and sample: a
#: hash of 18 (counted as above, its per-sample base once a sample), the
#: uniform of 4, and the box's width, product and sum (3)
PRIOR_OPS_PER_PARAM = 18 + 4 + 3


def wave_ops(model: CompartmentalModel, lowered: LoweredSummary, batch: int,
             schedule=None) -> float:
    """Operations of one launch of the wave entry: those of the theta-in
    entry (`ops_per_sample_day`) and the prior draw of every theta column,
    with the prior hash's per-sample base (3) and the NaN test of the
    distance (1); under a schedule also one product a scaled parameter and
    window (base * scale)."""
    num_days = lowered.obs_summary.shape[1]
    schedule = active_schedule(schedule)
    width = model.n_params if schedule is None else schedule.param_width(model)
    window_ops = 0 if schedule is None else schedule.n_scales
    return (ops_per_sample_day(model, lowered) * num_days
            + PRIOR_OPS_PER_PARAM * width + window_ops + 3 + 1) * batch


def bytes_moved(model: CompartmentalModel, batch: int, num_days: int,
                width: int | None = None, pool: int = 1) -> int:
    """Device-memory bytes of one launch of either entry, each input read
    once and each output written once: theta's `width` columns (the model's
    parameters by default) read (by the wave entry, written), the observed
    summary [n_chan, T], one distance written; for a regional model also
    the channel weights [n_chan] and, coupled, the mobility matrix [R, R]
    (which the kernel reads again for each block, as the flat one reads the
    observed summary; those re-reads stay in L2 and are not counted)."""
    width = model.n_params if width is None else width
    if not model.is_regional:
        return 4 * (width * batch + model.n_observed * num_days + batch)
    n_chan = regional_channels(model, pool)
    mob = model.n_regions ** 2 if model.coupled else 0
    return 4 * (width * batch + n_chan * (num_days + 1) + mob + batch)
