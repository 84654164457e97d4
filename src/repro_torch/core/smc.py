"""SMC-ABC: sequential Monte Carlo ABC with a falling tolerance (port).

Counterpart of `repro.core.smc`, the batched ABC-PMC variant
(Beaumont-style) of paper §2.2: round 0 keeps the best `n_particles` of a
prior wave (or re-simulates a warm-start population), and each later round
sets its tolerance at a quantile of the last population's distances,
proposes full batches by resampling the particles by weight and perturbing
them with a Gaussian kernel, keeps the first `n_particles` proposals at or
below the tolerance, and reweights them by prior / kernel mixture.

Two round loops (`SMCConfig.wave_loop`):

  * host: numpy's `default_rng(seed)` draws the parents and the
    perturbations, and each wave's distances come back to the host;
  * device (`make_smc_round_fn`): the parents are drawn by inverse CDF, a
    counter-hash uniform against the cumsum of the weights
    (`torch.searchsorted`), the perturbations are counter-hash normals, and
    each wave runs the kernel's theta-in entry under the device gate
    `accepted < n_particles` before `core.abc.compact_accepted`; the host
    enqueues segments of `core.abc.SEGMENT_WAVES` waves and syncs once a
    segment, as the ABC device wave loop does.

With a process group (`run_smc_abc(..., group=...)`, the device round
only) each round is sharded as `repro`'s `make_sharded_smc_round_fn` shards
it (`core.distributed`'s execution model: a rank a shard, NCCL on cards,
gloo on the CPU): the parents are replicated on every rank, each rank
proposes `batch_size / n` a wave with the seeds of (round seed, wave,
rank), runs the theta-in entry under the gate `global accepted <
n_particles` and compacts into its own segment, and one all-reduce of the
count a wave feeds the gate. At the round's end the segments are gathered in
shard order and the first `n_particles` kept. Rank 0's seeds are the
unsharded round's, so a world of 1 is the single round bit for bit.

The streams are the port's hash, not `repro`'s threefry, so SMC is held to
`repro` by its statistics and formulas (`_weighted_var`,
`importance_weights`), not bitwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import abc as abc_core
from repro_torch.core.abc import (
    ABCConfig,
    compact_accepted,
    make_simulator,
    run_param_names,
    sync_counts,
    tolerance32,
)
from repro_torch.core.distributed import gather
from repro_torch.core.posterior import Posterior
from repro_torch.core.priors import UniformBoxPrior, schedule_prior
from repro_torch.device import resolve_device
from repro_torch.epi.data import CountryData
from repro_torch.epi.models import get_model
from repro_torch.kernels import rng as krng

#: hash streams of (round seed, wave): the prior and simulation seeds of
#: round 0, then each wave's parent, perturbation and simulation seeds.
#: A round's seed is stream ROUND_STREAM of (seed, round).
PRIOR_STREAM, SIM_STREAM, PARENT_STREAM, PERTURB_STREAM, ROUND_STREAM = range(5)


def wave_seed(seed: int, rnd: int, wave: int, stream: int, shard: int = 0) -> int:
    """The uint32 seed of `stream` for wave `wave` of round `rnd`; shard s
    >= 1 of a sharded round hashes it with (s, `abc.SHARD_STREAM`)."""
    s = krng.stream_seed(krng.stream_seed(seed, rnd, ROUND_STREAM), wave, stream)
    return s if shard == 0 else krng.stream_seed(s, shard, abc_core.SHARD_STREAM)


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    n_particles: int = 256
    batch_size: int = 4096  # proposals per wave
    n_rounds: int = 4
    quantile: float = 0.5  # eps_{t+1} = this quantile of current distances
    kernel_scale: float = 2.0  # Beaumont: perturbation var = scale * weighted var
    num_days: int = 49
    #: the fused CUDA kernel on a CUDA device, its plain version on the CPU
    backend: str = "cuda"
    max_waves_per_round: int = 200
    min_tolerance: float = 0.0
    #: the model to infer: a registry name or a spec (e.g. a regionalized one)
    model: object = "siard"
    #: regional models only: a row-stochastic [R][R] mobility override
    mobility: Optional[Tuple[Tuple[float, ...], ...]] = None
    distance: str = "euclidean"
    #: summary statistic: a name, a SummarySpec or None for the raw series
    summary: Optional[object] = None
    #: intervention schedule; particles widen with the scale columns, and a
    #: pinned (zero-width) scale is never perturbed
    schedule: Optional[object] = None
    #: "host": numpy proposal loop, one sync a wave; "device": segments of
    #: gated waves with a device particle buffer, one sync a segment. The
    #: streams differ; both are seeded and deterministic.
    wave_loop: str = "host"
    #: warm start: round 0 resamples this population [N, p] by
    #: `initial_weights` (uniform when None) to n_particles and
    #: re-simulates it against the current dataset
    initial_particles: Optional[object] = None
    initial_weights: Optional[object] = None

    def __post_init__(self):
        if self.wave_loop not in ("host", "device"):
            raise ValueError(f"unknown wave_loop {self.wave_loop!r}")
        if self.backend != "cuda":
            raise ValueError(
                f"unknown backend {self.backend!r}; this slice of the port has "
                "the 'cuda' backend only"
            )
        if self.initial_weights is not None and self.initial_particles is None:
            raise ValueError("initial_weights given without initial_particles")
        if self.initial_particles is not None:
            init = np.asarray(self.initial_particles, np.float32)
            if init.ndim != 2 or init.shape[0] == 0:
                raise ValueError(
                    f"initial_particles must be a non-empty [N, p] array, "
                    f"got shape {init.shape}"
                )
            if self.initial_weights is not None:
                w = np.asarray(self.initial_weights, np.float64)
                if w.shape != (init.shape[0],):
                    raise ValueError(
                        f"initial_weights shape {w.shape} does not match "
                        f"{init.shape[0]} initial particles"
                    )
                if (w < 0).any() or not np.isfinite(w).all() or w.sum() <= 0:
                    raise ValueError(
                        "initial_weights must be finite, non-negative and "
                        "sum to a positive value"
                    )


def _weighted_var(theta: np.ndarray, w: np.ndarray) -> np.ndarray:
    mu = np.average(theta, axis=0, weights=w)
    return np.average((theta - mu) ** 2, axis=0, weights=w) + 1e-12


def importance_weights(new_theta: np.ndarray, particles: np.ndarray, weights: np.ndarray,
                       sigma: np.ndarray, free: np.ndarray,
                       prior: UniformBoxPrior) -> np.ndarray:
    """w_i ∝ prior(theta_i) / sum_j w_j K(theta_i | theta_j), normalized; a
    population whose weights all vanish gets uniform weights. Pinned
    dimensions divide by 1 (their differences are exactly 0) and stay out
    of the kernel's normalization."""
    denom_sig = np.where(free, sigma, 1.0)
    diff = (new_theta[:, None, :] - particles[None, :, :]) / denom_sig[None, None, :]
    log_k = -0.5 * np.sum(diff * diff, axis=-1)  # [new, old], up to a constant
    log_k -= np.sum(np.log(sigma[free]))  # the kernel's normalization (shared)
    mx = log_k.max(axis=1, keepdims=True)
    denom = (weights[None, :] * np.exp(log_k - mx)).sum(axis=1)
    log_prior = prior.log_pdf(torch.from_numpy(np.ascontiguousarray(new_theta))).numpy()
    w = np.exp(log_prior - (np.log(denom) + mx[:, 0]))
    w = np.where(np.isfinite(w), w, 0.0)
    return w / w.sum() if w.sum() > 0 else np.full_like(w, 1.0 / len(w))


def make_sharded_smc_round_fn(group, simulator, prior: UniformBoxPrior, cfg: SMCConfig):
    """The device SMC round sharded over the ranks of `group`: the same
    round_fn as `make_smc_round_fn`, with `batch_size / n` proposals a rank
    a wave, drawn with this rank's seeds; its buffer's segment gathered in
    shard order at the round's end, the first `n_particles` kept."""
    n = dist.get_world_size(group)
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by {n} devices")
    return make_smc_round_fn(simulator, prior, cfg, group=group)


def make_smc_round_fn(simulator, prior: UniformBoxPrior, cfg: SMCConfig, group=None):
    """The device SMC round (the SMC face of the ABC device wave loop).

    round_fn(seed, rnd, particles [n, p], weights [n], sigma [p], eps,
             max_waves) -> (theta [k, p], dist [k], accepted, waves)

    Wave w of round `rnd` resamples `batch_size` parents by inverse CDF and
    perturbs them by sigma * counter-hash normals; a proposal outside the
    box, or with a NaN distance, gets +inf. The theta-in entry runs under
    the gate `accepted < n_particles`, and `compact_accepted` keeps the
    proposals at or below eps (in float32) in a buffer of `n_particles +
    batch_size` rows, until `n_particles` are accepted or `max_waves` waves
    have run. The host enqueues `SEGMENT_WAVES` waves at a time and reads
    the counts once a segment. Returns the first k = min(accepted,
    n_particles) accepted rows in stream order, on the host.
    """
    n_p = cfg.n_particles
    shard, n_shards = 0, 1
    if group is not None:
        shard, n_shards = dist.get_rank(group), dist.get_world_size(group)
    B = cfg.batch_size // n_shards
    cap = n_p + B  # a final wave's overshoot always fits a shard
    dev = simulator.device

    def round_fn(seed: int, rnd: int, particles: np.ndarray, weights: np.ndarray,
                 sigma: np.ndarray, eps: float, max_waves: int):
        p = particles.shape[1]
        cdf = np.cumsum(np.asarray(weights, np.float64))
        cdf = (cdf / cdf[-1]).astype(np.float32)
        cdf[-1] = 1.0  # every uniform in (0, 1] finds a parent
        cdf = torch.from_numpy(cdf).to(dev)
        parts = torch.from_numpy(np.ascontiguousarray(particles, np.float32)).to(dev)
        sig = torch.from_numpy(np.asarray(sigma, np.float32)).to(dev)
        lo, hi = (torch.tensor(b, dtype=torch.float32, device=dev)
                  for b in (prior.lows, prior.highs))
        idx = torch.arange(B, device=dev)
        ctr = torch.arange(p, device=dev)[None, :]
        th_buf = torch.zeros((cap + 1, p), dtype=torch.float32, device=dev)
        d_buf = torch.full((cap + 1,), float("inf"), dtype=torch.float32, device=dev)
        fill = torch.zeros((1,), dtype=torch.int64, device=dev)
        total = fill  # one shard: the fill before clamping
        tol = tolerance32(eps)
        waves_done = accepted = 0
        while accepted < n_p and waves_done < max_waves:
            first, seg = waves_done, min(abc_core.SEGMENT_WAVES, max_waves - waves_done)
            waves = torch.zeros((1,), dtype=torch.int64, device=dev)
            for w in range(first, first + seg):
                active = total < n_p
                u = krng.uniform_open(wave_seed(seed, rnd, w, PARENT_STREAM, shard), idx, 0)
                parents = torch.searchsorted(cdf, u)
                z = krng.normal(wave_seed(seed, rnd, w, PERTURB_STREAM, shard), idx[:, None],
                                ctr)
                prop = parts.index_select(0, parents) + sig * z
                inside = ((prop >= lo) & (prop <= hi)).all(dim=1)
                d = simulator(prop, wave_seed(seed, rnd, w, SIM_STREAM, shard),
                              gate=active.to(torch.int32))
                d = torch.where(torch.isnan(d) | ~inside, float("inf"), d)
                th_buf, d_buf, new_fill = compact_accepted(th_buf, d_buf, fill, prop, d,
                                                           (d <= tol) & active, cap)
                if group is None:
                    total = new_fill
                else:
                    count = new_fill - fill
                    dist.all_reduce(count, group=group)  # the one collective a wave
                    total = total + count
                fill = new_fill
                waves += active
            ran, accepted = sync_counts(waves, total)  # the segment's one host sync
            simulator.record_gated("distance", B, seg - ran)
            waves_done += ran
        if group is None:
            k = min(accepted, n_p)
            return (th_buf[:k].cpu().numpy(), d_buf[:k].cpu().numpy(), accepted, waves_done)
        # the round's host re-entry: every shard's rows, in shard order
        fills = [int(f) for f in gather(fill.clamp(max=cap), group)]
        top = max(fills)
        ths, ds = gather(th_buf[:top], group), gather(d_buf[:top], group)
        th = np.concatenate([t[:c].cpu().numpy() for t, c in zip(ths, fills)])[:n_p]
        d = np.concatenate([x[:c].cpu().numpy() for x, c in zip(ds, fills)])[:n_p]
        return th, d, accepted, waves_done

    return round_fn


def run_smc_abc(
    dataset: CountryData,
    cfg: SMCConfig,
    seed: int = 0,
    prior: Optional[UniformBoxPrior] = None,
    verbose: bool = False,
    device="cuda",
    group=None,
) -> Posterior:
    """The final particle population as a Posterior (with its weights). The
    tolerance of each round is in `post.round_eps`, the waves of each round
    in `post.round_waves`. With a process group each round's waves are
    sharded over its ranks (`make_sharded_smc_round_fn`; the device round
    only): every rank runs round 0 and the host's arithmetic alike and
    returns the same population."""
    if group is not None and cfg.wave_loop != "device":
        raise ValueError("sharded SMC requires wave_loop='device'")
    device = resolve_device(device)
    spec = get_model(cfg.model)
    prior = prior or schedule_prior(spec, cfg.schedule)
    abc_cfg = ABCConfig(
        batch_size=cfg.batch_size, tolerance=np.inf, target_accepted=cfg.n_particles,
        strategy="topk", top_k=cfg.batch_size, num_days=cfg.num_days, backend=cfg.backend,
        model=cfg.model, schedule=cfg.schedule, distance=cfg.distance, summary=cfg.summary,
        mobility=cfg.mobility,
    )
    sim = make_simulator(dataset, abc_cfg, device)
    round_fn = None
    if group is not None:
        round_fn = make_sharded_smc_round_fn(group, sim, prior, cfg)
    elif cfg.wave_loop == "device":
        round_fn = make_smc_round_fn(sim, prior, cfg)
    lo = np.asarray(prior.lows, np.float32)
    hi = np.asarray(prior.highs, np.float32)
    # zero-width prior dims are point masses (pinned intervention scales):
    # they get no perturbation noise and stay out of the kernel density
    free = np.asarray(prior.free_dims(), bool)
    rng = np.random.default_rng(seed)
    n_p, B = cfg.n_particles, cfg.batch_size
    t0 = time.time()

    # --- round 0
    if cfg.initial_particles is not None:
        # warm start: resample the given population by weight to exactly
        # n_particles and re-simulate it against the current dataset
        init = np.asarray(cfg.initial_particles, np.float32)
        if init.shape[1] != lo.shape[0]:
            raise ValueError(
                f"initial_particles have width {init.shape[1]}; model "
                f"{spec.name!r} with this schedule expects {lo.shape[0]}"
            )
        w0 = (np.asarray(cfg.initial_weights, np.float64)
              if cfg.initial_weights is not None else np.full(init.shape[0], 1.0))
        # a stale fit may sit just outside a changed box: clip, so that its
        # prior density stays finite
        init = np.clip(init, lo, hi)
        particles = init[rng.choice(init.shape[0], size=n_p, replace=True, p=w0 / w0.sum())]
        d0 = sim(torch.from_numpy(particles).to(device),
                 wave_seed(seed, 0, 0, SIM_STREAM)).cpu().numpy()
        dists = np.where(np.isnan(d0), np.inf, d0).astype(np.float32)
        sims = n_p
    else:
        # cold start: one prior wave, keep the best n_particles
        theta0, d0 = sim.wave(prior, wave_seed(seed, 0, 0, PRIOR_STREAM),
                              wave_seed(seed, 0, 0, SIM_STREAM), B)
        d0 = d0.cpu().numpy()
        order = np.argsort(d0, kind="stable")[:n_p]
        particles, dists = theta0.cpu().numpy()[order], d0[order]
        sims = B
    weights = np.full(n_p, 1.0 / n_p)
    finite = dists[np.isfinite(dists)]
    eps = float(np.max(finite)) if finite.size else float("inf")

    round_eps, round_waves = [], []
    for rnd in range(1, cfg.n_rounds + 1):
        eps = max(float(np.quantile(dists, cfg.quantile)), cfg.min_tolerance)
        sigma = np.sqrt(cfg.kernel_scale * _weighted_var(particles, weights))
        sigma = np.where(free, sigma, 0.0).astype(np.float32)
        new_theta = np.zeros_like(particles)
        new_dist = np.full(n_p, np.inf, np.float32)
        if round_fn is not None:
            th, d, _, waves = round_fn(seed, rnd, particles, weights, sigma, eps,
                                       cfg.max_waves_per_round)
            n_done = th.shape[0]
            new_theta[:n_done], new_dist[:n_done] = th, d
            sims += waves * B
        else:
            n_done = waves = 0
            for wave in range(cfg.max_waves_per_round):
                # propose a full batch: resample parents by weight, perturb
                parents = rng.choice(n_p, size=B, p=weights)
                prop = particles[parents] + rng.normal(
                    0.0, sigma, size=(B, particles.shape[1])).astype(np.float32)
                inside = np.all((prop >= lo) & (prop <= hi), axis=1)
                d = sim(torch.from_numpy(prop).to(device),
                        wave_seed(seed, rnd, wave, SIM_STREAM)).cpu().numpy()
                d = np.where(np.isnan(d) | ~inside, np.inf, d)
                sims += B
                waves += 1
                take = np.nonzero(d <= eps)[0][: n_p - n_done]
                if take.size:
                    new_theta[n_done:n_done + take.size] = prop[take]
                    new_dist[n_done:n_done + take.size] = d[take]
                    n_done += take.size
                if n_done >= n_p:
                    break
        if n_done < n_p:
            # the population could not be refreshed at this tolerance: keep
            # the best of the old one (the documented fallback)
            keep = np.argsort(dists)[: n_p - n_done]
            new_theta[n_done:] = particles[keep]
            new_dist[n_done:] = dists[keep]
        weights = importance_weights(new_theta, particles, weights, sigma, free, prior)
        particles, dists = new_theta, new_dist
        round_eps.append(eps)
        round_waves.append(waves)
        if verbose:
            print(f"[smc] round {rnd}: eps={eps:.4g} mean_dist={dists.mean():.4g} "
                  f"ess={1.0 / np.sum(weights ** 2):.1f} waves={waves}")

    post = Posterior(
        theta=particles,
        distances=dists,
        tolerance=eps,
        param_names=run_param_names(abc_cfg, spec),
        runs=cfg.n_rounds,
        simulations=sims,
        wall_time_s=time.time() - t0,
        weights=weights,
    )
    post.round_eps = round_eps  # type: ignore[attr-defined]
    post.round_waves = round_waves  # type: ignore[attr-defined]
    return post
