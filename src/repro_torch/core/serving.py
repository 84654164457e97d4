"""Epidemiology forecast serving: amortized posterior queries over cached
fits (port of `repro.core.serving`).

Posterior estimation is the expensive offline phase; forecasts and
counterfactuals are cheap forward simulations that a server can batch.
Three pieces, with `repro`'s names and contracts:

  * `ForecastKernelCache`: one posterior-predictive simulator per forecast
    shape (model, total days, particle count, theta width, schedule shape).
    It compiles nothing: an entry holds a `single` and a `batched` callable
    over `epi.engine.simulate_observed`, whose seed, dataset scalars and
    breakpoint days are run-time values, so every (country, intervention
    day, scale) of a shape shares the entry. `batched` simulates L query
    lanes of N particles as one [L * N] batch in which each particle keeps
    its in-lane index of the counter-hash stream, so lane l's rows are
    bitwise what `single` gives for lane l alone; `single` is `batched`
    over one lane.
  * `PosteriorStore`: a filesystem posterior cache keyed by (dataset
    version, model, summary, distance, schedule shape), with atomic swaps
    (tmp + rename of the `.npz` payload and of `index.json`). Its files are
    `repro`'s byte for byte in layout, so either package reads what the
    other wrote; so are the dataset files and `dataset_version`.
  * `EpiServer`: answers `ForecastQuery` batches. It groups queries by
    forecast shape, pads each group to `slots` lanes, answers a group with
    one `batched` call and copies the trajectories to the host once a call;
    it fits posteriors on demand with the port's `run_smc_abc` (the
    theta-in entries of the CUDA `abc_sim` kernel on the card), warm-started
    from the previous dataset version's population, or with
    `fit_backend="npe"` from one amortized estimator a cache key
    (`core.npe`), trained once and fine-tuned when a dataset version moves:
    no waves and no `abc_sim` launch.

Streams. `repro` draws the subsample permutation and the forecast noise
from threefry keys, which have no PyTorch twin. The port derives two
counter-hash streams of the query seed (`krng.stream_seed(seed, 0, s)`):
`SUBSAMPLE_STREAM` orders the particles by `krng.hash_u32` of their index
(`subsample_particles`), `FORECAST_STREAM` seeds the forecast's noise. So a
query's bands are the port's own, held to `repro`'s by distribution, and
batched answers are bitwise the sequential `forecast_bands` ones.

Bands are taken on the host: `bands_payload` runs `np.quantile` over the
trajectory stack exactly as `repro` does, so one stack gives dict-equal
payloads in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import npe as npe_mod
from repro_torch.core.abc import ABCConfig
from repro_torch.core.campaign import _jsonable, schedule_shape_key
from repro_torch.core.posterior import Posterior
from repro_torch.core.smc import SMCConfig, run_smc_abc
from repro_torch.core.summaries import get_summary
from repro_torch.device import resolve_device
from repro_torch.epi import engine
from repro_torch.epi.data import CountryData, get_dataset
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import EpiModelConfig, InterventionSchedule
from repro_torch.ioutils import atomic_write_text as _atomic_write_text
from repro_torch.kernels import rng as krng

# --------------------------------------------------------------- particles

#: stream of a query seed that orders the particles for the subsample (the
#: fold_in salt of `repro`'s permutation key); sequential and batched paths
#: must pick the same subset
SUBSAMPLE_STREAM = 0x5EED
#: stream of a query seed that seeds the forecast's noise
FORECAST_STREAM = 0xF0CA


def forecast_seed(seed: int) -> int:
    """The uint32 seed of a query's forecast noise."""
    return krng.stream_seed(seed, 0, FORECAST_STREAM)


def subsample_particles(theta, key, max_particles: int) -> np.ndarray:
    """Seeded-permutation subsample of an accepted set.

    topk accepted sets are distance-ordered, so `theta[:k]` is biased toward
    the lowest-distance particles and narrows the credible bands; the
    particles ordered by a hash of their index under the query seed `key`
    (`SUBSAMPLE_STREAM`) keep the subset an unbiased draw from the full set.
    Deterministic in (key, N).
    """
    theta = np.asarray(theta, np.float32)
    n = theta.shape[0]
    if n <= max_particles:
        return theta
    order = krng.hash_u32(krng.stream_seed(key, 0, SUBSAMPLE_STREAM), torch.arange(n), 0)
    # the hash is a bijection of the index, so there are no ties
    perm = np.argsort(order.numpy(), kind="stable")
    return theta[perm[:max_particles]]


def _widen_for_schedule(spec, theta, counterfactual, fc_sched):
    """theta columns for the forecast schedule.

    Forecast under the FIT schedule: theta already carries the fitted scale
    columns; pass through. Counterfactual: keep the base parameters, append
    the counterfactual's pinned scales (broadcast to every particle)."""
    if not counterfactual:
        return theta
    base = theta[:, : spec.n_params]
    if fc_sched is None or fc_sched.is_empty:
        return base
    scales = np.asarray(
        [s for row in fc_sched.fixed_scales() for s in row], np.float32
    )
    return np.concatenate(
        [base, np.broadcast_to(scales, (base.shape[0], scales.size))], axis=1
    )


def _breakpoint_arg(fc_sched) -> torch.Tensor:
    if fc_sched is None or fc_sched.is_empty:
        return torch.zeros((0,), dtype=torch.int64)
    return torch.tensor(fc_sched.breakpoints, dtype=torch.int64)


def _scalars(ds: CountryData) -> np.ndarray:
    """(population, a0, r0, d0) in float32, as the kernel's constants hold
    them."""
    return np.asarray([ds.population, ds.a0, ds.r0, ds.d0], np.float32)


# ----------------------------------------------------------- kernel cache
class ForecastKernelCache:
    """One posterior-predictive simulator per forecast shape.

    Key: (model, total_days, n_particles, theta width) + schedule shape.
    Dataset scalars (population, a0, r0, d0), the seed and the breakpoint
    days are run-time arguments, so one entry serves every country and
    intervention timing of a shape; counterfactual scale values ride theta
    columns. `get` returns (single, batched):

        batched(theta [L, N, W], seeds [L], population [L], a0 [L], r0 [L],
                d0 [L], breakpoints [L, n_windows]) -> [L, N, n_obs, T]
        single(theta [N, W], seed, population, a0, r0, d0,
               breakpoints [n_windows]) -> [N, n_obs, T]

    on theta's device. Nothing is compiled: an entry is a pair of closures,
    and `n_compiled` counts entries.
    """

    def __init__(self):
        self._fns: Dict[tuple, tuple] = {}

    @property
    def n_compiled(self) -> int:
        return len(self._fns)

    def key_of(self, model_name, total_days, n_particles, width, fc_sched):
        return (
            model_name, int(total_days), int(n_particles), int(width),
        ) + schedule_shape_key(fc_sched)

    def get(self, spec, total_days, n_particles, width, fc_sched):
        key = self.key_of(spec.name, total_days, n_particles, width, fc_sched)
        if key in self._fns:
            return self._fns[key]
        # only the schedule's shape is fixed; same-shape schedules pass their
        # own breakpoints and theta scale columns
        sched = None if fc_sched is None or fc_sched.is_empty else fc_sched
        days = int(total_days)

        def batched(theta, seeds, population, a0, r0, d0, breakpoints):
            lanes, n, width_ = theta.shape
            dev = theta.device

            def rows(x, dtype):  # a value a lane -> a value a particle
                return torch.as_tensor(x, dtype=dtype, device=dev).reshape(
                    lanes).repeat_interleave(n)

            f32 = torch.float32
            cfg = EpiModelConfig(population=rows(population, f32), num_days=days,
                                 a0=rows(a0, f32), r0=rows(r0, f32), d0=rows(d0, f32))
            bp = None
            if sched is not None:
                bp = torch.as_tensor(breakpoints, dtype=torch.int64, device=dev).reshape(
                    lanes, sched.n_windows).repeat_interleave(n, dim=0)
            traj = engine.simulate_observed(
                spec, theta.reshape(lanes * n, width_), rows(seeds, torch.int64), cfg,
                sched, breakpoints=bp,
                sample_index=torch.arange(n, device=dev).repeat(lanes))
            return traj.reshape((lanes, n) + tuple(traj.shape[1:]))

        def single(theta, seed, population, a0, r0, d0, breakpoints):
            return batched(theta[None], [seed], [population], [a0], [r0], [d0],
                           torch.as_tensor(breakpoints)[None])[0]

        entry = (single, batched)
        self._fns[key] = entry
        return entry


#: process-default cache behind sequential `posterior_forecast` calls
DEFAULT_KERNELS = ForecastKernelCache()


# ------------------------------------------------------------------ bands
def bands_payload(
    traj: np.ndarray,  # [N, n_obs, T]
    spec,
    dataset: CountryData,
    fit_days: int,
    horizon: int,
    fc_sched: Optional[InterventionSchedule],
    quantiles: Sequence[float],
) -> dict:
    """Credible-band payload from a posterior-predictive trajectory stack
    on the host.

    Strict JSON (no NaN/inf); the same field layout and numpy reductions as
    `repro`'s, so one stack gives dict-equal payloads in both packages, and
    the sequential and batched paths give dict-equal ones here."""
    channels = {}
    for m, name in enumerate(spec.observed):
        ch = traj[:, m, :]  # [N, T]
        bands = {"mean": ch.mean(axis=0).tolist()}
        for q in quantiles:
            bands[f"q{int(round(q * 100)):02d}"] = np.quantile(
                ch, q, axis=0
            ).tolist()
        channels[name] = bands
    payload = {
        "model": spec.name,
        "dataset": dataset.name,
        "fit_days": int(fit_days),
        "horizon_days": int(horizon),
        "total_days": int(fit_days) + int(horizon),
        "n_particles": int(traj.shape[0]),
        "schedule": None
        if fc_sched is None or fc_sched.is_empty
        else dataclasses.asdict(fc_sched),
        "quantiles": list(quantiles),
        "channels": channels,
        "observed": {
            name: dataset.observed[m, : int(fit_days)].tolist()
            for m, name in enumerate(spec.observed)
        },
    }
    return _jsonable(payload)


def forecast_bands(
    theta,
    dataset: CountryData,
    *,
    model,
    fit_days: int,
    horizon: int,
    fit_schedule: Optional[InterventionSchedule] = None,
    schedule: Optional[InterventionSchedule] = None,
    key: int = 0,
    quantiles: Sequence[float] = (0.05, 0.25, 0.5, 0.75, 0.95),
    max_particles: int = 512,
    kernels: Optional[ForecastKernelCache] = None,
    device="cuda",
) -> dict:
    """Sequential posterior-predictive forecast (one query, one call) on
    `device`; `key` is the query seed.

    The single-query face of the serving layer: `posterior_forecast` in
    launch/abc_run.py delegates here, so the CLI path and the batched server
    share every step (seeded subsample, schedule widening, forecast core,
    payload assembly)."""
    device = resolve_device(device)
    spec = get_model(model)
    counterfactual = schedule is not None
    fc_sched = schedule if counterfactual else fit_schedule
    theta = np.asarray(theta, np.float32)
    if theta.shape[0] == 0:
        raise ValueError("no accepted samples to forecast from")
    theta = subsample_particles(theta, key, max_particles)
    theta = _widen_for_schedule(spec, theta, counterfactual, fc_sched)
    total_days = int(fit_days) + int(horizon)
    kernels = kernels or DEFAULT_KERNELS
    single, _ = kernels.get(
        spec, total_days, theta.shape[0], theta.shape[1], fc_sched
    )
    traj = single(
        torch.from_numpy(np.ascontiguousarray(theta)).to(device),
        forecast_seed(key),
        *_scalars(dataset),
        _breakpoint_arg(fc_sched),
    ).cpu().numpy()
    return bands_payload(
        traj, spec, dataset, fit_days, horizon, fc_sched, quantiles
    )


# ---------------------------------------------------------------- queries
@dataclasses.dataclass(frozen=True)
class ForecastQuery:
    """One serving request: forecast or counterfactual credible bands.

    `schedule=None` forecasts under the FIT schedule; an
    InterventionSchedule with fixed scales is a counterfactual ("what if
    alpha drops to 0.5x on day 20"). In the JSON form, `schedule` is the
    CLI grammar string (`PARAMS@day[=scale][,day...]`, see
    `parse_intervention`); the string "none" lifts every intervention
    (counterfactual under the empty schedule)."""

    dataset: str
    model: str = "siard"
    horizon: int = 14
    schedule: Optional[InterventionSchedule] = None
    quantiles: Tuple[float, ...] = (0.05, 0.25, 0.5, 0.75, 0.95)
    seed: int = 0

    @property
    def kind(self) -> str:
        return "counterfactual" if self.schedule is not None else "forecast"

    @staticmethod
    def from_json(d: dict) -> "ForecastQuery":
        from repro_torch.epi.spec import EMPTY_SCHEDULE
        from repro_torch.launch.abc_run import parse_intervention

        sched = d.get("schedule")
        if isinstance(sched, str):
            s = sched.strip()
            sched = (
                EMPTY_SCHEDULE if not s or s.lower() == "none"
                else parse_intervention(s)
            )
        elif sched is not None:
            raise ValueError(
                f"query schedule must be a grammar string or null, got "
                f"{type(sched).__name__}"
            )
        return ForecastQuery(
            dataset=d["dataset"],
            model=d.get("model", "siard"),
            horizon=int(d.get("horizon", 14)),
            schedule=sched,
            quantiles=tuple(d.get("quantiles", (0.05, 0.25, 0.5, 0.75, 0.95))),
            seed=int(d.get("seed", 0)),
        )


# ----------------------------------------------------------- dataset files
def dataset_version(ds: CountryData) -> str:
    """Content hash of a dataset: the freshness axis of the posterior cache
    key. Re-fits trigger on a content change (new daily rows), never on file
    mtime churn. `repro`'s hash, so both packages version a dataset alike."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(ds.observed, np.float32).tobytes())
    h.update(
        f"{ds.name}|{ds.population}|{ds.a0}|{ds.r0}|{ds.d0}|{ds.model}".encode()
    )
    return h.hexdigest()[:12]


def save_dataset_file(path: str, ds: CountryData) -> None:
    """Serialize a CountryData to the serving JSON schema (atomic write)."""
    payload = {
        "name": ds.name,
        "population": float(ds.population),
        "a0": float(ds.a0),
        "r0": float(ds.r0),
        "d0": float(ds.d0),
        "model": ds.model,
        "observed_channels": list(ds.observed_channels),
        "observed": np.asarray(ds.observed, np.float32).tolist(),
    }
    _atomic_write_text(path, json.dumps(payload, indent=1, allow_nan=False))


def load_dataset_file(path: str, model=None) -> CountryData:
    """Load a dataset from the serving JSON schema (see save_dataset_file).

    `model` optionally re-tags the series for a different registry spec with
    matching observed channels (the get_dataset compatibility rule)."""
    with open(path) as f:
        raw = json.load(f)
    try:
        ds = CountryData(
            name=str(raw["name"]),
            population=float(raw["population"]),
            a0=float(raw.get("a0", 100.0)),
            r0=float(raw.get("r0", 0.0)),
            d0=float(raw.get("d0", 0.0)),
            observed=np.asarray(raw["observed"], np.float32),
            model=str(raw.get("model", "siard")),
            observed_channels=tuple(raw.get("observed_channels", ("A", "R", "D"))),
            synthetic=True,
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed dataset file {path!r}: {e}") from e
    if ds.observed.ndim != 2:
        raise ValueError(
            f"dataset file {path!r}: observed must be [n_channels, T], got "
            f"shape {ds.observed.shape}"
        )
    if model is not None and model != ds.model:
        spec = get_model(model)
        if not ds.compatible_with(spec):
            raise ValueError(
                f"dataset {ds.name!r} holds {ds.observed_channels} series; "
                f"model {spec.name!r} observes {spec.observed}"
            )
        ds = dataclasses.replace(ds, model=spec.name)
    return ds


# ------------------------------------------------------------------ store
class PosteriorStore:
    """Filesystem posterior cache with atomic entry swap.

    One versioned .npz per cache key (written by Posterior.save, itself
    atomic) plus an index.json routing key -> current version, rewritten
    tmp+rename. Readers resolve through the index, so a re-fit becomes
    visible only at the single atomic index swap: a crash mid-refit leaves
    the previous complete entry being served. Stale versions are pruned
    after the swap."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "index.json")

    # -- index ------------------------------------------------------------
    def _read_index(self) -> dict:
        try:
            with open(self._index_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
        except (json.JSONDecodeError, OSError) as e:
            raise ValueError(
                f"corrupt posterior-store index {self._index_path!r} ({e}); "
                "delete it to rebuild the store from scratch"
            ) from e

    def keys(self) -> Tuple[str, ...]:
        return tuple(sorted(self._read_index()))

    def version_of(self, key: str) -> Optional[str]:
        entry = self._read_index().get(key)
        return None if entry is None else entry["version"]

    # -- entries ----------------------------------------------------------
    @staticmethod
    def _slug(key: str) -> str:
        return "".join(c if c.isalnum() or c in "._-" else "_" for c in key)

    def _file_of(self, key: str, version: str) -> str:
        return os.path.join(self.root, f"{self._slug(key)}-{version}.npz")

    def put(self, key: str, version: str, posterior: Posterior) -> None:
        """Atomic swap: persist the new version's payload, then flip the
        index entry in one rename; prune the superseded payload after."""
        path = self._file_of(key, version)
        posterior.save(path)
        index = self._read_index()
        old = index.get(key)
        index[key] = {
            "version": version,
            "file": os.path.basename(path),
            "n": len(posterior),
            "simulations": int(posterior.simulations),
            "tolerance": float(posterior.tolerance),
            "updated_at": time.time(),
        }
        _atomic_write_text(
            self._index_path, json.dumps(index, indent=1, allow_nan=False)
        )
        if old and old["file"] != os.path.basename(path):
            stale = os.path.join(self.root, old["file"])
            if os.path.exists(stale):
                os.unlink(stale)

    def get(self, key: str, version: str) -> Optional[Posterior]:
        """The posterior for (key, version), or None on miss/stale."""
        entry = self._read_index().get(key)
        if entry is None or entry["version"] != version:
            return None
        return Posterior.load(os.path.join(self.root, entry["file"]))

    def latest(self, key: str) -> Optional[Tuple[str, Posterior]]:
        """Newest stored (version, posterior) for a key: the warm-start
        source when the dataset content has moved past it."""
        entry = self._read_index().get(key)
        if entry is None:
            return None
        return entry["version"], Posterior.load(
            os.path.join(self.root, entry["file"])
        )


# ----------------------------------------------------------------- server
def _default_fit() -> SMCConfig:
    """`repro`'s template on the port's backend and the device round."""
    return SMCConfig(
        n_particles=128, batch_size=4096, n_rounds=3, quantile=0.5,
        num_days=21, backend="cuda", model="siard", wave_loop="device",
    )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """EpiServer policy: microbatch width, forecast particles, fit template.

    `fit` is the SMC template applied to every dataset the server must fit
    on demand (its `model` field is overridden per query); `fit.num_days`
    is the fitting window every forecast extends past."""

    slots: int = 8
    forecast_particles: int = 128
    fit: SMCConfig = dataclasses.field(default_factory=_default_fit)
    fit_seed: int = 0
    #: directory of <name>.json dataset files; bundled registry datasets
    #: (italy / new_zealand / usa / synthetic_small) resolve when no file
    #: of that name exists
    data_dir: Optional[str] = None
    #: PosteriorStore directory (None = in-memory cache only)
    store_dir: Optional[str] = None
    #: "smc" fits per dataset version via SMC-ABC waves; "npe" trains one
    #: amortized estimator per (model, summary, schedule) and answers every
    #: version with a forward pass (+ optional fine-tune on version change)
    fit_backend: str = "smc"
    #: fit_backend="npe" only: training hyperparameters (core.npe.NPEConfig);
    #: None uses the NPEConfig defaults
    npe: Optional[object] = None

    def __post_init__(self):
        if self.fit_backend not in ("smc", "npe"):
            raise ValueError(
                f"unknown fit_backend {self.fit_backend!r} "
                "(expected 'smc' or 'npe')"
            )
        if self.npe is not None:
            npe_mod.resolve_npe_config(self.npe)
            if self.fit_backend != "npe":
                raise ValueError("cfg.npe is set but fit_backend is not 'npe'")


class EpiServer:
    """Batched posterior-query server over a posterior cache, on `device`.

    `answer(queries)` groups compatible queries by forecast shape and drives
    each group through ONE `batched` call on a fixed `slots`-lane microbatch
    (padding lanes repeat lane 0 and are discarded): the continuous-batching
    pattern of launch/serve.py with forecast queries in the slots.
    Posteriors come from the in-memory cache, then the PosteriorStore, then
    an on-demand SMC fit (warm-started from the previous dataset version
    when one is cached) or, with `fit_backend="npe"`, a forward pass of the
    key's estimator (trained, loaded or fine-tuned on `device`).
    """

    def __init__(self, cfg: ServeConfig, device="cuda"):
        if cfg.slots < 1:
            raise ValueError("slots must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kernels = ForecastKernelCache()
        self.store = (
            PosteriorStore(cfg.store_dir) if cfg.store_dir else None
        )
        #: base cache key -> (dataset version, posterior)
        self._posteriors: Dict[str, Tuple[str, Posterior]] = {}
        #: fit_backend="npe": base cache key -> trained NPEstimator
        self._estimators: Dict[str, object] = {}
        self.fits = 0
        self.warm_fits = 0
        self.batched_calls = 0
        self.npe_trains = 0
        self.npe_fine_tunes = 0

    # -- cache keys --------------------------------------------------------
    def posterior_key(self, dataset_name: str, model: str) -> str:
        """Everything the fit depends on except the data content: (model,
        summary, distance, schedule-shape); the dataset VERSION rides next
        to the key so a content change invalidates without renaming."""
        f = self.cfg.fit
        shape = schedule_shape_key(f.schedule)
        shape_tag = (
            "none" if not shape else f"w{shape[0]}_" + "+".join(shape[1])
        )
        return (
            f"{dataset_name}__{model}__{get_summary(f.summary).tag()}"
            f"__{f.distance}__{shape_tag}"
        )

    # -- datasets ----------------------------------------------------------
    def dataset(self, name: str, model: str) -> Tuple[CountryData, str]:
        """Resolve a dataset to exactly the fit window and version it.

        File-backed (`data_dir/<name>.json`) series win over bundled
        registry names; files longer than the fit window are truncated to
        it (the daily-update flow appends rows, moving the version)."""
        fit_days = self.cfg.fit.num_days
        if self.cfg.data_dir:
            path = os.path.join(self.cfg.data_dir, f"{name}.json")
            if os.path.exists(path):
                ds = load_dataset_file(path, model=model)
                if ds.num_days < fit_days:
                    raise ValueError(
                        f"dataset {name!r} has {ds.num_days} days; the fit "
                        f"window needs {fit_days}"
                    )
                if ds.num_days > fit_days:
                    ds = dataclasses.replace(
                        ds, observed=ds.observed[:, :fit_days]
                    )
                return ds, dataset_version(ds)
        ds = get_dataset(name, num_days=fit_days, model=model)
        return ds, dataset_version(ds)

    # -- posteriors --------------------------------------------------------
    def preload(self, name: str, model: str, posterior: Posterior) -> None:
        """Install a posterior for the dataset's CURRENT version (tests /
        external fits); the server will answer from it without fitting."""
        _, version = self.dataset(name, model)
        self._posteriors[self.posterior_key(name, model)] = (version, posterior)

    def refresh(self, name: str, model: str) -> str:
        """Ensure the cached posterior matches the dataset content.

        Returns "cached" (fresh already), "warm_refit" (re-fit seeded from
        the previous version's population) or "cold_fit"."""
        _, _, status = self._ensure(name, model)
        return status

    def get_posterior(self, name: str, model: str):
        post, ds, _ = self._ensure(name, model)
        return post, ds

    def _ensure(self, name: str, model: str):
        ds, version = self.dataset(name, model)
        bk = self.posterior_key(name, model)
        hit = self._posteriors.get(bk)
        if hit is not None and hit[0] == version:
            return hit[1], ds, "cached"
        if self.cfg.fit_backend == "npe":
            return self._ensure_npe(bk, ds, version)
        if self.store is not None:
            stored = self.store.get(bk, version)
            if stored is not None:
                self._posteriors[bk] = (version, stored)
                return stored, ds, "cached"
        # stale or missing: fit, warm-started from the newest prior version
        warm = hit[1] if hit is not None else None
        if warm is None and self.store is not None:
            latest = self.store.latest(bk)
            warm = latest[1] if latest is not None else None
        post = self._fit(ds, model, warm)
        self._posteriors[bk] = (version, post)
        if self.store is not None:
            self.store.put(bk, version, post)
        return post, ds, "warm_refit" if warm is not None else "cold_fit"

    def _estimator_path(self, bk: str) -> Optional[str]:
        """Where a trained estimator lives on disk (beside the store)."""
        if self.cfg.store_dir is None:
            return None
        return os.path.join(self.cfg.store_dir, "npe", f"{PosteriorStore._slug(bk)}.npz")

    def _npe_train_cfg(self, model: str):
        """The backend='npe' ABCConfig of the SMC fit template: the same
        model, window, summary, distance and schedule, so NPE and SMC
        posteriors of a dataset share the cache key."""
        f = self.cfg.fit
        return ABCConfig(
            model=model, num_days=f.num_days, backend="npe",
            summary=f.summary, distance=f.distance, schedule=f.schedule,
            mobility=f.mobility, target_accepted=f.n_particles,
            npe=self.cfg.npe,
        )

    def _ensure_npe(self, bk: str, ds: CountryData, version: str):
        """The amortized path: an estimator is trained at most once a cache
        key and answers every dataset version with a forward pass. A version
        change while an estimator exists costs `NPEConfig.fine_tune_steps`
        gradient steps (0: a free refresh), never a wave fit (`self.fits`
        stays as it is)."""
        if self.store is not None:
            stored = self.store.get(bk, version)
            if stored is not None:
                self._posteriors[bk] = (version, stored)
                return stored, ds, "cached"
        cfg = self._npe_train_cfg(ds.model)
        est = self._estimators.get(bk)
        path = self._estimator_path(bk)
        if est is None and path is not None and os.path.exists(path):
            est = npe_mod.NPEstimator.load(path, device=self.device)
        if est is None:
            est = npe_mod.train_npe(ds, cfg, seed=self.cfg.fit_seed, device=self.device)
            self.npe_trains += 1
            status = "cold_fit"
        else:
            # the estimator amortizes over content, but the posterior cache
            # missed: the version moved (or the cache is cold); refresh with
            # a short fine-tune against the current scalars
            est = npe_mod.fine_tune(est, ds, seed=self.cfg.fit_seed)
            self.npe_fine_tunes += 1
            status = "warm_refit"
        self._estimators[bk] = est
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            est.save(path)
        post = est.sample_posterior(ds.observed, self.cfg.fit.n_particles,
                                    seed=self.cfg.fit_seed)
        self._posteriors[bk] = (version, post)
        if self.store is not None:
            self.store.put(bk, version, post)
        return post, ds, status

    def _fit(self, ds: CountryData, model: str, warm: Optional[Posterior]):
        fit = dataclasses.replace(self.cfg.fit, model=model)
        if warm is not None:
            expected = len(
                fit.schedule.param_names(get_model(model))
                if fit.schedule is not None and not fit.schedule.is_empty
                else get_model(model).param_names
            )
            if warm.theta.shape[1] == expected:
                fit = dataclasses.replace(
                    fit,
                    initial_particles=warm.theta,
                    initial_weights=warm.weights,
                )
                self.warm_fits += 1
            else:
                warm = None  # incompatible width (model/schedule changed)
        self.fits += 1
        return run_smc_abc(ds, fit, seed=self.cfg.fit_seed, device=self.device)

    # -- answering ---------------------------------------------------------
    def answer(self, queries: Sequence[ForecastQuery]) -> List[dict]:
        """Answer a batch of queries; responses align with query order.

        Queries sharing a forecast shape share one cache entry and are
        answered `slots` lanes at a time through its batched callable; a
        mixed batch across S shapes costs ceil(group/slots) calls per
        shape, so 8 queries over 2 schedules take 2 calls at 4 slots."""
        results: List[Optional[dict]] = [None] * len(queries)
        groups: Dict[tuple, List[int]] = {}
        prep: List[tuple] = []
        for i, q in enumerate(queries):
            post, ds = self.get_posterior(q.dataset, q.model)
            spec = get_model(q.model)
            counterfactual = q.schedule is not None
            fc_sched = q.schedule if counterfactual else self.cfg.fit.schedule
            th = subsample_particles(
                post.theta, q.seed, self.cfg.forecast_particles
            )
            th = _widen_for_schedule(spec, th, counterfactual, fc_sched)
            total_days = self.cfg.fit.num_days + int(q.horizon)
            gkey = self.kernels.key_of(
                spec.name, total_days, th.shape[0], th.shape[1], fc_sched
            )
            groups.setdefault(gkey, []).append(i)
            prep.append((th, forecast_seed(q.seed), ds, fc_sched, spec, total_days, q))
        for idxs in groups.values():
            for start in range(0, len(idxs), self.cfg.slots):
                chunk = idxs[start: start + self.cfg.slots]
                self._answer_chunk(chunk, prep, results)
        return results  # every entry filled: each query joined one chunk

    def _answer_chunk(self, chunk, prep, results) -> None:
        """One batched call over <= slots same-shape lanes; the trajectories
        come to the host in one copy."""
        lanes = chunk + [chunk[0]] * (self.cfg.slots - len(chunk))
        th0, _, _, fc_sched, spec, total_days, _ = prep[chunk[0]]
        theta = torch.from_numpy(np.stack([prep[i][0] for i in lanes])).to(self.device)
        seeds = torch.tensor([prep[i][1] for i in lanes], dtype=torch.int64)
        scalars = torch.from_numpy(np.stack([_scalars(prep[i][2]) for i in lanes]))
        bp = torch.stack([_breakpoint_arg(prep[i][3]) for i in lanes])
        _, batched = self.kernels.get(
            spec, total_days, th0.shape[0], th0.shape[1], fc_sched
        )
        traj = batched(theta, seeds, *scalars.unbind(1), bp).cpu().numpy()
        self.batched_calls += 1
        for lane, i in enumerate(chunk):
            _, _, ds_i, sched_i, spec_i, _, q = prep[i]
            results[i] = bands_payload(
                traj[lane], spec_i, ds_i, self.cfg.fit.num_days, q.horizon,
                sched_i, q.quantiles,
            )

    def stats(self) -> dict:
        """`repro`'s keys and counters."""
        return {
            "fits": self.fits,
            "warm_fits": self.warm_fits,
            "batched_calls": self.batched_calls,
            "compiled_shapes": self.kernels.n_compiled,
            "npe_trains": self.npe_trains,
            "npe_fine_tunes": self.npe_fine_tunes,
        }
