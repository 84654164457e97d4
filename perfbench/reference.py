"""The benchmark's plain reference: an ABC posterior worked out again in
plain PyTorch, row by row, from the seeds alone.

It imports nothing of the measured program. It follows the arithmetic that
the program documents for its fused kernel (`abc_sim`) and its device wave
loop, so that in float32 it gives the same bits:

  * a counter hash: the murmur3 finalizer, twice, of (seed, sample index,
    counter) in 32-bit words; a uniform on (0, 1] from its top 24 bits, and a
    normal by Box-Muller (cos branch) from counters 2c and 2c + 1;
  * wave w of a posterior under seed s draws with the prior seed
    `stream_seed(s, w, 0)` and the simulation seed `stream_seed(s, w, 1)`;
    the tolerance pilot's wave w with streams 2 and 3 of the pilot seed;
  * theta = low + u * (high - low), u the uniform of (prior seed, sample,
    parameter);
  * a day of tau-leaping: n_k = floor(h_k + sqrt(h_k) * z_k), each count
    clamped to what its source compartment still holds, in declaration
    order; transition k of region r draws counter day * slots + r * T + k;
    a row with no source (an inflow) is clamped at zero alone, as if its
    source held without limit, and what it adds is not held by a later
    row's source that day;
  * the identity summary under the Euclidean distance, accumulated day by
    day and channel by channel, NaN distances read as +inf;
  * a posterior is every sample with distance <= tolerance (in float32) of
    waves 0, 1, ... in stream order, up to the first wave at which the count
    reaches the target.

A model's rows come from `perfbench/models/<model>.py`, with its optional
hooks (`coupled_inputs`, `region_constants`; `perfbench/README.md`). A
configuration's arrays (`{"file": "<name>.npy"}` of `mobility` and
`populations`) are float32 files under `perfbench/configs/`. `dtype` runs
the same arithmetic in a lower precision, the control of
`perfbench/control.py`.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M1, M2 = 0x85EBCA6B, 0xC2B2AE35
P1, P2, X1 = 0x9E3779B1, 0x85EBCA77, 0x1B873593
TWO_PI = float(np.float32(2.0 * np.pi))
INV_2_24 = float(np.float32(1.0 / (1 << 24)))
PRIOR_STREAM, SIM_STREAM, PILOT_PRIOR_STREAM, PILOT_SIM_STREAM = range(4)
#: hash counter slots a day of a flat model
CTR_SLOTS = 8
#: elements of the widest [rows, transitions] tensor a block holds
BLOCK_ELEMENTS = 32_000_000
#: where a configuration's array files lie
CONFIGS = Path(__file__).resolve().parent / "configs"


def _mul32(x, m: int):
    """(x * m) mod 2**32 of 32-bit words held in int64 (or Python ints)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * m + ((hi * (m & 0xFFFF)) << 16)) & MASK32


def fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def hash32(seed, idx, ctr):
    """The counter hash of 32-bit words (ints or int64 tensors)."""
    return fmix32(fmix32(seed ^ _mul32(idx, P1) ^ _mul32(ctr, P2) ^ X1))


def stream_seed(seed: int, index: int, stream: int) -> int:
    """The 32-bit seed of `stream` of run `index` under `seed`."""
    return int(hash32(int(seed) & MASK32, int(index) & MASK32, int(stream) & MASK32))


def uniform(seed, idx, ctr, dtype=torch.float32) -> torch.Tensor:
    """U in (0, 1]: ((h >> 8) + 1) * 2^-24."""
    return ((hash32(seed, idx, ctr) >> 8) + 1).to(dtype) * INV_2_24


def normal(seed, idx, ctr, dtype=torch.float32) -> torch.Tensor:
    """A standard normal from counters (2 ctr, 2 ctr + 1)."""
    u1 = uniform(seed, idx, (ctr * 2) & MASK32, dtype)
    u2 = uniform(seed, idx, (ctr * 2 + 1) & MASK32, dtype)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def ring_mobility(n_regions: int, eps: float):
    """Each region keeps 1 - eps and sends eps / 2 to each ring neighbour
    (eps to the other region of two)."""
    rows = []
    for r in range(n_regions):
        row = [0.0] * n_regions
        row[r] = 1.0 - eps
        if n_regions == 2:
            row[(r + 1) % 2] = eps
        elif n_regions > 2:
            row[(r - 1) % n_regions] += eps / 2.0
            row[(r + 1) % n_regions] += eps / 2.0
        rows.append(row)
    return rows


def config_array(entry: dict, shape: tuple) -> np.ndarray:
    """The float32 array of a configuration's `{"file": "<name>.npy"}`,
    read from `CONFIGS` and checked against `shape`."""
    arr = np.load(CONFIGS / entry["file"], allow_pickle=False)
    if arr.dtype != np.float32 or arr.shape != tuple(shape):
        raise ValueError(f"{entry['file']}: a float32 array of shape {tuple(shape)} is "
                         f"wanted, not {arr.dtype} {arr.shape}")
    return arr


def config_mobility(cfg: dict):
    """The configuration's [R][R] mobility as lists of floats: a ring
    (`{"ring": eps}`), a file (`{"file": "<name>.npy"}`, row r weighting
    each region q's mass in region r), or None (the identity)."""
    mob, n = cfg.get("mobility"), int(cfg["regions"])
    if not mob:
        return None
    if set(mob) == {"ring"}:
        return ring_mobility(n, mob["ring"])
    if set(mob) == {"file"}:
        return config_array(mob, (n, n)).tolist()
    raise ValueError(f"mobility {mob!r}: a ring or a file is wanted")


class Model:
    """One configuration file's model, series scalars and prior."""

    def __init__(self, cfg: dict):
        rows = importlib.import_module(f"perfbench.models.{cfg['model']}")
        if (cfg["summary"], cfg["distance"]) != ("identity", "euclidean"):
            raise ValueError("the reference computes the identity summary under the "
                             "euclidean distance only")
        self.rows = rows
        self.n_regions = int(cfg["regions"])
        self.regional = self.n_regions > 1 or bool(rows.COUPLED)
        self.n_state = len(rows.COMPARTMENTS)
        self.n_trans = len(rows.STOICHIOMETRY)
        self.obs_idx = [rows.COMPARTMENTS.index(c) for c in rows.OBSERVED]
        self.coupled_idx = [rows.COMPARTMENTS.index(c) for c in rows.COUPLED]
        self.sources = [row.index(-1) if -1 in row else None for row in rows.STOICHIOMETRY]
        self.n_chan = self.n_regions * len(self.obs_idx)
        total = self.n_regions * self.n_trans
        self.slots = max(CTR_SLOTS, -(-total // 8) * 8)
        mob = config_mobility(cfg)
        self.mobility = np.eye(self.n_regions).tolist() if mob is None else mob
        pops = cfg.get("populations")
        if pops and not self.regional:
            raise ValueError(f"{cfg['model']} is flat: per-region populations need regions")
        #: [R] float32 populations, or None: population / R each
        self.populations = config_array(pops, (self.n_regions,)) if pops else None
        self.coupled_inputs = getattr(rows, "coupled_inputs", None)
        self.region_constants = getattr(rows, "region_constants", None)
        self.seed_region = int(cfg.get("seed_region", 0))
        self.scalars = tuple(float(cfg[k]) for k in ("population", "a0", "r0", "d0"))
        self.days = int(cfg["days"])
        self.highs = [float(h) for h in cfg["prior_highs"]]
        self.lows = [float(x) for x in cfg.get("prior_lows", [0.0] * len(self.highs))]
        if len(self.lows) != len(self.highs):
            raise ValueError("prior_lows and prior_highs differ in length")

    @property
    def n_params(self) -> int:
        return len(self.highs)

    def on(self, device, dtype=torch.float32) -> "Consts":
        return Consts(self, torch.device(device), dtype)


class Consts:
    """A model's constant tensors on one device, made before any work is
    enqueued there (a copy from the host would wait for the device)."""

    def __init__(self, model: Model, device: torch.device, dtype):
        self.m, self.device, self.dtype = model, device, dtype
        self.mob = torch.tensor(model.mobility, dtype=dtype, device=device)
        self.pop = (None if model.populations is None
                    else torch.tensor(model.populations, device=device).to(dtype))
        self.constants = ()
        if model.region_constants is not None:
            mob32 = torch.tensor(model.mobility, dtype=torch.float32, device=device)
            pop32 = (torch.tensor(model.populations, device=device)
                     if model.populations is not None
                     else torch.tensor(model.scalars[0], dtype=torch.float32,
                                       device=device) / model.n_regions)
            self.constants = tuple(r.to(dtype) for r in model.region_constants(mob32, pop32))
        self.lo = torch.tensor(model.lows, dtype=dtype, device=device)
        self.hi = torch.tensor(model.highs, dtype=dtype, device=device)
        self.obs_idx = torch.tensor(model.obs_idx, dtype=torch.int64, device=device)
        self.observed = None

    def scalar(self, x) -> torch.Tensor:
        return torch.full((), float(x), dtype=self.dtype, device=self.device)

    def region_population(self, pop: torch.Tensor) -> torch.Tensor:
        """The population row a regional model's rows see: the
        configuration's [R] populations, or the scalar pop / R."""
        return pop / self.m.n_regions if self.pop is None else self.pop

    def with_observed(self, observed: np.ndarray) -> "Consts":
        self.observed = torch.tensor(np.asarray(observed, np.float32),
                                     device=self.device).to(self.dtype)
        return self


def prior_draw(c: Consts, seed, idx: torch.Tensor) -> torch.Tensor:
    """theta [N, p] of sample indices `idx` [N] under prior seeds `seed`
    (an int or [N, 1])."""
    ctr = torch.arange(c.m.n_params, device=c.device)[None, :]
    u = uniform(seed, idx[:, None], ctr, c.dtype)
    return c.lo + u * (c.hi - c.lo)


def initial_state(c: Consts, theta: torch.Tensor) -> torch.Tensor:
    """[N, C] (flat) or [N, R, C] (regional)."""
    m = c.m
    pop, a0, r0, d0 = (c.scalar(x) for x in m.scalars)
    if not m.regional:
        pc = tuple(theta[:, k] for k in range(m.n_params))
        return torch.stack(list(m.rows.initial_rows(pc, pop, a0, r0, d0)), dim=-1)
    pc = tuple(theta[:, k:k + 1] for k in range(m.n_params))
    z = torch.zeros((m.n_regions,), dtype=c.dtype, device=c.device)
    z[m.seed_region] = 1.0
    rows = m.rows.initial_rows(pc, c.region_population(pop), a0 * z, r0 * z, d0 * z)
    n = theta.shape[0]
    return torch.stack([torch.broadcast_to(r, (n, m.n_regions)) for r in rows], dim=-1)


def hazards(c: Consts, state: torch.Tensor, pc) -> torch.Tensor:
    """Clamped rates [N, R * T], region-major."""
    m = c.m
    pop = c.scalar(m.scalars[0])
    if not m.regional:
        sc = tuple(state[:, k] for k in range(m.n_state))
        return torch.clamp_min(torch.stack(list(m.rows.hazard_rows(sc, pc, pop)), dim=-1),
                               0.0)
    sc = tuple(state[..., k] for k in range(m.n_state))
    popr = c.region_population(pop)
    inputs = (m.coupled_inputs(sc, popr) if m.coupled_inputs is not None
              else tuple(sc[j] for j in m.coupled_idx))
    coupled = []
    for x in inputs:
        row = c.mob[:, 0] * x[:, 0:1]
        for q in range(1, m.n_regions):
            row = row + c.mob[:, q] * x[:, q:q + 1]
        coupled.append(row)
    rows = m.rows.hazard_rows(sc + tuple(coupled) + c.constants, pc, popr)
    n = state.shape[0]
    h = torch.stack([torch.broadcast_to(r, (n, m.n_regions)) for r in rows], dim=-1)
    return torch.clamp_min(h, 0.0).reshape(n, m.n_regions * m.n_trans)


def apply_counts(c: Consts, state: torch.Tensor, n_raw: torch.Tensor) -> torch.Tensor:
    """Clamp each count to its source's remaining mass, in declaration
    order, and apply the stoichiometry in the same order. A row with no
    source (an inflow) is clamped at zero alone."""
    m = c.m
    if m.regional:
        n_raw = n_raw.reshape(state.shape[0], m.n_regions, m.n_trans)
    sc = [state[..., k] for k in range(m.n_state)]
    remaining, counts = {}, []
    for k, src in enumerate(m.sources):
        if src is None:
            counts.append(torch.clamp_min(n_raw[..., k], 0.0))
            continue
        avail = remaining.get(src, sc[src])
        n_k = torch.clamp(n_raw[..., k], min=torch.zeros_like(avail), max=avail)
        remaining[src] = avail - n_k
        counts.append(n_k)
    for k, row in enumerate(m.rows.STOICHIOMETRY):
        for j, coef in enumerate(row):
            if coef == 1:
                sc[j] = sc[j] + counts[k]
            elif coef == -1:
                sc[j] = sc[j] - counts[k]
    return torch.stack(sc, dim=-1)


def param_rows(c: Consts, theta: torch.Tensor):
    m = c.m
    if m.regional:
        return tuple(theta[:, k:k + 1] for k in range(m.n_params))
    return tuple(theta[:, k] for k in range(m.n_params))


def day_step(c: Consts, state, pc, seed, idx, day: int):
    """One day: the next state and its observed channels [N, R * n_obs]."""
    m = c.m
    total = m.n_regions * m.n_trans
    ctr = (torch.arange(total, device=c.device) + (day & MASK32) * m.slots) & MASK32
    z = normal(seed, idx[:, None], ctr[None, :], c.dtype)
    h = hazards(c, state, pc)
    state = apply_counts(c, state, torch.floor(h + torch.sqrt(h) * z))
    if m.regional:
        x = state[:, :, c.obs_idx].reshape(state.shape[0], m.n_chan)
    else:
        x = state[:, c.obs_idx]
    return state, x


def running_day(c: Consts, x, obs_t, binv, acc):
    """The identity summary's carry and the squared residuals, channel by
    channel: acc += 1 * (1 * (binv + x - obs)^2); the carry then resets."""
    one = c.scalar(1.0)
    binv = binv + x
    diff = binv - obs_t
    term = diff * diff
    for k in range(term.shape[-1]):
        acc = acc + one * (one * term[..., k])
    return binv * (1.0 - one), acc


def finalize(acc: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(acc * 1.0)
    return torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)


def distances(c: Consts, theta: torch.Tensor, seed, idx: torch.Tensor) -> torch.Tensor:
    """Distances [N] of theta [N, p] against `c.observed`; `seed` is the
    simulation seed (an int or [N, 1]), `idx` the samples' hash indices."""
    state = initial_state(c, theta)
    pc = param_rows(c, theta)
    binv = torch.zeros((theta.shape[0], c.m.n_chan), dtype=c.dtype, device=c.device)
    acc = torch.zeros((theta.shape[0],), dtype=c.dtype, device=c.device)
    for day in range(c.m.days):
        state, x = day_step(c, state, pc, seed, idx, day)
        binv, acc = running_day(c, x, c.observed[:, day], binv, acc)
    return finalize(acc)


def observed_series(model: Model, theta, seed: int) -> np.ndarray:
    """The observed series [R * n_obs, T] (float32) of one sample at
    `theta`, simulated on the CPU with `seed`, sample index 0."""
    c = model.on("cpu")
    th = torch.tensor([theta], dtype=torch.float32)
    idx = torch.zeros((1,), dtype=torch.int64)
    state, pc, cols = initial_state(c, th), param_rows(c, th), []
    for day in range(model.days):
        state, x = day_step(c, state, pc, int(seed) & MASK32, idx, day)
        cols.append(x[0])
    return torch.stack(cols, dim=-1).numpy().astype(np.float32)


#: most waves a call of `posterior` enqueues at once
MAX_GROUP = 16


def _rows_per_piece(m: Model) -> int:
    return max(1, BLOCK_ELEMENTS // (m.n_regions * m.n_trans))


def _enqueue(c: Consts, seed: int, streams, w0: int, n_waves: int, batch: int):
    """Waves w0 .. w0 + n_waves - 1 under `seed` as pieces of rows, each
    piece's seeds and sample indices worked out on the device from its row
    numbers (nothing is copied from the host), all enqueued before any is
    read: [(theta, dist, wave)] in row order."""
    rows, total, s = _rows_per_piece(c.m), n_waves * batch, int(seed) & MASK32
    out = []
    for a in range(0, total, rows):
        r = torch.arange(a, min(a + rows, total), device=c.device)
        wave = torch.div(r, batch, rounding_mode="floor")
        idx = r - wave * batch
        wave = wave + w0
        ps = hash32(s, wave, streams[0])[:, None]
        ss = hash32(s, wave, streams[1])[:, None]
        theta = prior_draw(c, ps, idx)
        out.append((theta, distances(c, theta, ss, idx), wave))
    return out


def pilot_tolerance(c: Consts, seed: int, quantile: float, n_pilot: int, batch: int) -> float:
    """The tolerance at `quantile` of a pilot of `n_pilot` prior-predictive
    distances in waves of min(n_pilot, batch) samples."""
    per_wave = min(n_pilot, batch)
    n_waves = max(1, n_pilot // per_wave)
    pieces = _enqueue(c, seed, (PILOT_PRIOR_STREAM, PILOT_SIM_STREAM), 0, n_waves,
                      per_wave)
    d = np.concatenate([dist.float().cpu().numpy() for _, dist, _ in pieces])
    return float(np.quantile(d[np.isfinite(d)], quantile))


def posterior(c: Consts, seed: int, tolerance: float, batch: int, target: int, max_waves: int):
    """(theta [n, p], dist [n], waves) of the posterior under `seed`: every
    sample with distance <= tolerance (float32) of waves 0, 1, ... up to the
    first wave at which `target` are accepted, or `max_waves`."""
    tol = float(np.float32(tolerance))
    group = max(1, min(MAX_GROUP, _rows_per_piece(c.m) // batch))
    thetas, dists, n, w = [], [], 0, 0
    while n < target and w < max_waves:
        g = min(group, max_waves - w)
        th, d, wv = [], [], []
        for theta, dist, wave in _enqueue(c, seed, (PRIOR_STREAM, SIM_STREAM), w, g,
                                          batch):
            ok = dist.float() <= tol
            th.append(theta[ok].float().cpu().numpy())
            d.append(dist[ok].float().cpu().numpy())
            wv.append(wave[ok].cpu().numpy())
        th, d, wv = np.concatenate(th), np.concatenate(d), np.concatenate(wv) - w
        cum = n + np.cumsum(np.bincount(wv, minlength=g))
        hit = np.nonzero(cum >= target)[0]
        last = int(hit[0]) if len(hit) else g - 1
        keep = wv <= last
        thetas.append(th[keep])
        dists.append(d[keep])
        n, w = int(cum[last]), w + last + 1
    return np.concatenate(thetas), np.concatenate(dists), w


def mismatched_rows(theta_a, dist_a, theta_b, dist_b) -> int:
    """Rows of two accepted sets, in order, that differ in any bit, and the
    rows that one set has beyond the other."""
    n = min(len(dist_a), len(dist_b))
    ta = np.ascontiguousarray(theta_a[:n], np.float32).view(np.int32)
    tb = np.ascontiguousarray(theta_b[:n], np.float32).view(np.int32)
    da = np.ascontiguousarray(dist_a[:n], np.float32).view(np.int32)
    db = np.ascontiguousarray(dist_b[:n], np.float32).view(np.int32)
    differ = (ta != tb).any(axis=1) | (da != db)
    return int(differ.sum()) + abs(len(dist_a) - len(dist_b))
