"""Amortized inference: neural posterior estimation over the tau-leap engine
(port of `repro.core.npe`).

The ABC and SMC backends pay about 1e6 simulations for each posterior fit.
NPE trains a conditional density estimator q(theta | x) once on simulator
output; a posterior for any observed series of the same shape is then one
forward pass, with no waves and no tolerance. Its parts:

  * the tau-leap engine as an endless source of training pairs:
    `epi.engine.simulate_features` gives a batch of `(theta ~ prior,
    x = summary(simulate(theta)))` on the device for each training step, so
    no dataset is ever written;
  * the conditioning features are `core.summaries.summary_features`, the
    flush-day summary values the ABC distance compares;
  * the estimator is a small mixture-density network (MDN) of
    `models.common` blocks (layer_norm + GELU MLP residual blocks) with a
    K-component diagonal-Gaussian head over box-standardized theta, trained
    with `repro`'s AdamW (`optim.adamw`) on gradients from autograd.

Entry points, each on `device` ("cuda" unless the caller asks for "cpu"):

  * `train_npe(dataset, cfg, seed)`: train an `NPEstimator` for an
    `ABCConfig(backend="npe")`. The dataset gives its scalars (population,
    a0, r0, d0) to the simulator, not its observed series.
  * `NPEstimator.sample_posterior(observed, n)`: one forward pass and n
    mixture draws, returned as the `Posterior` ABC returns (`distances`
    holds each draw's negative log-density, so `top(k)` picks the densest;
    `tolerance` is 0.0).
  * `fine_tune(est, dataset, seed)`: a few more steps on fresh simulations,
    the serving layer's re-fit (`abc_serve --backend npe`).
  * `run_npe(dataset, cfg, seed)`: train, then sample `cfg.target_accepted`
    draws for the dataset's series; `core.abc.run_abc` dispatches here.

Streams. `repro` keys every draw with threefry, which has no PyTorch twin.
The port draws from its counter hash (`kernels.rng`), the same on the CPU
and the card, in place of each threefry key:

  * training step i (from 1): prior seed `stream_seed(seed, i, PRIOR_STREAM)`
    and simulation seed `stream_seed(seed, i, SIM_STREAM)`, where `repro`
    folds i into the key; index 0 of the prior stream seeds the MDN's
    initial weights (`mdn_init`, which draws them on the CPU, so they are
    bitwise the same for every device);
  * the pilot: `stream_seed(seed, 0 | 1, _PILOT_SALT)`;
  * sampling: `stream_seed(seed, 0, _SAMPLE_SALT)`; draw j takes its
    component by inverse CDF over exp(log_pi) at `uniform_open(s, j, 0)`,
    then the component's Gaussian at `normal(s, j, 1 + dim)`.

So the port's estimator and draws are its own, held to `repro`'s by
statistics; the same seed gives the same bits on one device. A training
step reads nothing back to the host: the loss comes back as a float only at
a `verbose` print and at the end.

Estimator files are `repro`'s `.npz` layout (`meta`, `lows`, `highs`,
`feat_mean`, `feat_std` and `leaf_%03d` in `jax.tree.leaves` order), so
either package loads what the other saved.
"""

from __future__ import annotations

import dataclasses
import json
import time
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.abc import resolved_mobility, run_param_names
from repro_torch.core.posterior import Posterior
from repro_torch.core.priors import UniformBoxPrior, schedule_prior
from repro_torch.core.summaries import SummarySpec, summary_features
from repro_torch.device import resolve_device
from repro_torch.epi import engine
from repro_torch.epi.data import CountryData
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule
from repro_torch.ioutils import atomic_write
from repro_torch.kernels import rng as krng
from repro_torch.models.common import layer_norm, vanilla_mlp
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

#: salts (hash streams) of the pilot and the sampling seeds
_PILOT_SALT = 0x9112
_SAMPLE_SALT = 0x5A3D
#: hash streams of a training step's index: its prior draw, its simulation
PRIOR_STREAM, SIM_STREAM = 0, 1

#: softplus offset putting the initial component sigma near 0.45, wide
#: enough to cover the unit box before training shapes it
_SIGMA0 = -0.4328


@dataclasses.dataclass(frozen=True)
class NPEConfig:
    """Training hyperparameters of the NPE backend (`ABCConfig.npe`).

    The defaults train a small MDN on about 1e5 simulated pairs; production
    fits raise `train_steps`, `train_batch` and `hidden`.
    """

    #: gradient steps; each step simulates a fresh `train_batch` of pairs
    train_steps: int = 400
    #: simulations a step
    train_batch: int = 256
    #: MLP width of the conditioning trunk
    hidden: int = 64
    #: residual (layer_norm -> GELU MLP) blocks after the input projection
    n_layers: int = 2
    #: mixture components of the diagonal-Gaussian head
    n_components: int = 4
    lr: float = 3e-3
    weight_decay: float = 1e-4
    #: floor on component sigmas (box-standardized units)
    sigma_min: float = 1e-3
    #: prior-predictive simulations used to standardize the features once
    n_pilot: int = 512
    #: gradient steps of a serving re-fit (`fine_tune`); 0 makes a dataset
    #: refresh a pure forward pass
    fine_tune_steps: int = 100
    fine_tune_lr: float = 1e-3

    def __post_init__(self):
        if self.train_steps < 1:
            raise ValueError(f"train_steps must be >= 1, got {self.train_steps}")
        if self.train_batch < 2:
            raise ValueError(f"train_batch must be >= 2, got {self.train_batch}")
        if self.hidden < 1 or self.n_layers < 0 or self.n_components < 1:
            raise ValueError(
                f"invalid MDN shape: hidden={self.hidden} "
                f"n_layers={self.n_layers} n_components={self.n_components}"
            )
        if self.fine_tune_steps < 0:
            raise ValueError(
                f"fine_tune_steps must be >= 0, got {self.fine_tune_steps}"
            )
        if self.sigma_min <= 0:
            raise ValueError(f"sigma_min must be > 0, got {self.sigma_min}")


def resolve_npe_config(npe) -> NPEConfig:
    """None -> defaults; any other type than NPEConfig raises."""
    if npe is None:
        return NPEConfig()
    if not isinstance(npe, NPEConfig):
        raise TypeError(
            f"cfg.npe must be an NPEConfig or None, got {type(npe).__name__}"
        )
    return npe


def step_seeds(seed: int, index: int) -> Tuple[int, int]:
    """(prior seed, simulation seed) of training step `index` (from 1)."""
    return (krng.stream_seed(seed, index, PRIOR_STREAM),
            krng.stream_seed(seed, index, SIM_STREAM))


# ----------------------------------------------------------------- MDN core
def _normal_init(seed: int, index: int, shape, fan_in=None) -> torch.Tensor:
    """[rows, cols] float32 on the CPU: hash normals of stream `index` of
    `seed`, scaled by 1/sqrt(fan_in) (`models.common.ninit`'s scale)."""
    fan_in = fan_in or shape[0]
    s = krng.stream_seed(seed, index, 0)
    z = krng.normal(s, torch.arange(shape[0])[:, None], torch.arange(shape[1])[None, :])
    return z * float(1.0 / np.sqrt(max(fan_in, 1)))


def _mdn_tree(n_features: int, n_params: int, cfg: NPEConfig, make) -> dict:
    """The MDN's parameter tree with `make(name, index, shape, fan_in)` as
    each leaf; `repro`'s names and nesting."""
    K, p, H = cfg.n_components, n_params, cfg.hidden
    blocks = []
    for i in range(cfg.n_layers):
        blocks.append({
            "ln_s": make("ones", None, (H,), None),
            "ln_b": make("zeros", None, (H,), None),
            "w1": make("normal", 2 + 2 * i, (H, 2 * H), None),
            "b1": make("zeros", None, (2 * H,), None),
            "w2": make("normal", 3 + 2 * i, (2 * H, H), 2 * H),
            "b2": make("zeros", None, (H,), None),
        })
    return {
        "in_w": make("normal", 0, (n_features, H), None),
        "in_b": make("zeros", None, (H,), None),
        "blocks": tuple(blocks),
        "head_w": make("normal", 1, (H, K * (1 + 2 * p)), H),
        "head_b": make("head_b", None, (K * (1 + 2 * p),), None),
    }


def mdn_init(seed: int, n_features: int, n_params: int, cfg: NPEConfig,
             device="cpu") -> dict:
    """The mixture-density network's float32 parameters, drawn on the CPU
    from `seed` and moved to `device`.

    Trunk: input projection -> `n_layers` residual blocks (layer_norm + GELU
    MLP). Head: one linear layer to K * (1 + 2p) raw outputs (logits, means,
    sigma pre-activations). The head bias spreads the K component means
    across the unit box, so the mixture starts diverse, not collapsed.
    """
    K, p = cfg.n_components, n_params

    def make(kind, index, shape, fan_in):
        if kind == "normal":
            return _normal_init(seed, index, shape, fan_in)
        if kind == "ones":
            return torch.ones(shape, dtype=torch.float32)
        t = torch.zeros(shape, dtype=torch.float32)
        if kind == "head_b":
            # component k's mean starts at (k + 0.5) / K on every dimension
            t[K: K + K * p] = torch.from_numpy(
                np.repeat((np.arange(K) + 0.5) / K - 0.5, p).astype(np.float32))
        return t

    params = _mdn_tree(n_features, n_params, cfg, make)
    return tree_map(lambda t: t.to(device), params)


def mdn_template(n_features: int, n_params: int, cfg: NPEConfig) -> dict:
    """The parameter tree's shapes as tensors on the meta device (no data)."""
    return _mdn_tree(n_features, n_params, cfg,
                     lambda kind, index, shape, fan_in: torch.empty(shape, device="meta"))


def mdn_forward(
    params: dict, x: torch.Tensor, cfg: NPEConfig, n_params: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., F] -> (log_pi [..., K], mu [..., K, p], sigma [..., K, p]).

    mu is offset to the box center (0.5) and sigma floors at
    `cfg.sigma_min`, so an untrained net already gives a proper density over
    the standardized box. Both GELUs are the tanh form, `jax.nn.gelu`'s
    default.
    """
    K, p = cfg.n_components, n_params
    h = F.gelu((x @ params["in_w"] + params["in_b"]).to(torch.float32), approximate="tanh")
    for blk in params["blocks"]:
        h = h + vanilla_mlp(
            layer_norm(h, blk["ln_s"], blk["ln_b"]),
            blk["w1"], blk["b1"], blk["w2"], blk["b2"],
        )
    out = h @ params["head_w"] + params["head_b"]
    log_pi = torch.log_softmax(out[..., :K], dim=-1)
    mu = 0.5 + out[..., K: K + K * p].reshape(out.shape[:-1] + (K, p))
    raw = out[..., K + K * p:].reshape(out.shape[:-1] + (K, p))
    sigma = cfg.sigma_min + F.softplus(raw + _SIGMA0)
    return log_pi, mu, sigma


def _half_log_2pi(n_params: int) -> float:
    """0.5 * p * log(2 pi) in float32, as `repro` forms it."""
    return float(np.float32(0.5 * n_params) * np.log(np.float32(2.0 * np.pi)))


def mdn_log_prob(
    params: dict, x: torch.Tensor, theta_std: torch.Tensor, cfg: NPEConfig, n_params: int
) -> torch.Tensor:
    """Mixture log-density of box-standardized theta given features x.

    x [..., F], theta_std [..., p] -> [...]: K diagonal Gaussians reduced
    with a logsumexp over the components.
    """
    log_pi, mu, sigma = mdn_forward(params, x, cfg, n_params)
    t = theta_std.unsqueeze(-2)  # [..., 1, p]
    z = (t - mu) / sigma
    comp = (-0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(sigma), dim=-1)
            - _half_log_2pi(n_params))
    return torch.logsumexp(log_pi + comp, dim=-1)


def mdn_sample(
    params: dict, x: torch.Tensor, seed: int, n: int, cfg: NPEConfig, n_params: int
) -> torch.Tensor:
    """n standardized draws from q(theta | x) for ONE feature vector.

    x [F] -> theta_std [n, p]. Draw j takes its component by inverse CDF of
    the mixture weights at `uniform_open(seed, j, 0)`, then the component's
    diagonal Gaussian at the normals `normal(seed, j, 1 .. p)`; everything
    stays on x's device.
    """
    log_pi, mu, sigma = mdn_forward(params, x, cfg, n_params)
    idx = torch.arange(n, device=x.device)
    u = krng.uniform_open(seed, idx, 0)  # (0, 1]
    cdf = torch.cumsum(torch.exp(log_pi), dim=0)
    comp = (u[:, None] > cdf[None, :-1]).sum(dim=-1)  # [n] in [0, K-1]
    dims = torch.arange(1, n_params + 1, device=x.device)
    eps = krng.normal(seed, idx[:, None], dims[None, :])
    return mu[comp] + sigma[comp] * eps


# ------------------------------------------------------------- the estimator
@dataclasses.dataclass
class NPEstimator:
    """A trained amortized posterior q(theta | summary features).

    Tied to (model, num_days, summary, schedule, dataset scalars), not to
    the observed series: any new observation of the same shape is a forward
    pass. `params` live on one device (`device`), where every query runs.
    """

    model: str
    num_days: int
    summary: SummarySpec
    schedule: Optional[InterventionSchedule]
    npe: NPEConfig
    param_names: Tuple[str, ...]
    lows: np.ndarray  # [p] prior box (widened for the schedule)
    highs: np.ndarray  # [p]
    feat_mean: np.ndarray  # [F] pilot standardization
    feat_std: np.ndarray  # [F]
    params: dict  # MDN parameter tree, float32 tensors on one device
    train_steps_done: int = 0
    train_sims: int = 0
    train_wall_s: float = 0.0
    final_loss: float = float("nan")

    @property
    def n_params(self) -> int:
        return int(self.lows.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.feat_mean.shape[0])

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    def _widths(self) -> np.ndarray:
        # zero-width (pinned) dims train and sample at a constant 0 in
        # standardized space; the clamp only guards the division
        return np.maximum(self.highs - self.lows, 1e-6)

    def features_of(self, observed) -> np.ndarray:
        """Observed series [n_obs, T >= num_days] -> standardized features [F]."""
        obs = np.asarray(observed, np.float32)[:, : self.num_days]
        if obs.shape[-1] < self.num_days:
            raise ValueError(
                f"observed series has {obs.shape[-1]} days; this estimator "
                f"conditions on {self.num_days}"
            )
        spec = get_model(self.model)
        x = summary_features(self.summary, torch.from_numpy(obs.copy()),
                             spec.n_regions).numpy()
        if x.shape != self.feat_mean.shape:
            raise ValueError(
                f"observed summary has {x.shape[0]} features; estimator was "
                f"trained on {self.n_features} (wrong channels or summary?)"
            )
        return (x - self.feat_mean) / self.feat_std

    def _x(self, observed) -> torch.Tensor:
        return torch.from_numpy(self.features_of(observed)).to(self.device)

    @torch.no_grad()
    def sample_posterior(self, observed, n: int, seed: int = 0) -> Posterior:
        """n posterior draws conditioned on an observed series: one forward
        pass, no simulation.

        The `Posterior`'s `distances` hold each draw's negative log-density
        under the estimator, `tolerance` is 0.0 and `simulations` the
        training cost so far, which queries do not change.
        """
        t0 = time.time()
        s = krng.stream_seed(seed, 0, _SAMPLE_SALT)
        x = self._x(observed)
        t_std = mdn_sample(self.params, x, s, int(n), self.npe, self.n_params)
        t_std = torch.clamp(t_std, 0.0, 1.0)
        nlq = -mdn_log_prob(self.params, x, t_std, self.npe, self.n_params)
        theta = t_std.cpu().numpy() * self._widths() + self.lows
        theta = np.clip(theta, self.lows, self.highs)
        return Posterior(
            theta=theta,
            distances=nlq.cpu().numpy().astype(np.float32),
            tolerance=0.0,
            param_names=self.param_names,
            runs=0,
            simulations=self.train_sims,
            wall_time_s=time.time() - t0,
        )

    @torch.no_grad()
    def log_prob(self, observed, theta) -> np.ndarray:
        """Standardized-space log q(theta | observed) for each row of theta [N, p]."""
        t_std = (np.asarray(theta, np.float32) - self.lows) / self._widths()
        t_std = torch.from_numpy(np.ascontiguousarray(t_std, np.float32)).to(self.device)
        return mdn_log_prob(self.params, self._x(observed), t_std, self.npe,
                            self.n_params).cpu().numpy()

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Atomic `.npz` save in `repro`'s layout: an interrupted save never
        leaves a truncated estimator where the server reads. The parameters
        are stored as leaves in `jax.tree.leaves` order; `load` rebuilds the
        tree from the config."""
        meta = {
            "model": self.model,
            "num_days": self.num_days,
            "summary": dataclasses.asdict(self.summary),
            "schedule": None if self.schedule is None
            else dataclasses.asdict(self.schedule),
            "npe": dataclasses.asdict(self.npe),
            "param_names": list(self.param_names),
            "train_steps_done": int(self.train_steps_done),
            "train_sims": int(self.train_sims),
            "train_wall_s": float(self.train_wall_s),
            "final_loss": float(self.final_loss)
            if np.isfinite(self.final_loss) else None,
        }
        arrays = {
            "meta": np.asarray(json.dumps(meta)),
            "lows": self.lows, "highs": self.highs,
            "feat_mean": self.feat_mean, "feat_std": self.feat_std,
        }
        for i, leaf in enumerate(tree_leaves(self.params)):
            arrays[f"leaf_{i:03d}"] = leaf.detach().cpu().numpy().astype(np.float32)
        with atomic_write(path, "wb") as f:
            np.savez(f, **arrays)

    @staticmethod
    def load(path: str, device="cuda") -> "NPEstimator":
        """Load a saved estimator (either package's) onto `device`. A corrupt
        or truncated file raises ValueError with a remedy; a missing file
        raises FileNotFoundError."""
        device = resolve_device(device)
        try:
            z = np.load(path, allow_pickle=False)
            meta = json.loads(str(z["meta"]))
            npe_cfg = NPEConfig(**meta["npe"])
            summary = SummarySpec(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in meta["summary"].items()
            })
            sched = meta["schedule"]
            if sched is not None:
                sched = InterventionSchedule(
                    tv_params=tuple(sched["tv_params"]),
                    breakpoints=tuple(sched["breakpoints"]),
                    scale_lows=tuple(map(tuple, sched["scale_lows"])),
                    scale_highs=tuple(map(tuple, sched["scale_highs"])),
                )
            lows = np.asarray(z["lows"], np.float32)
            feat_mean = np.asarray(z["feat_mean"], np.float32)
            template = mdn_template(feat_mean.shape[0], lows.shape[0], npe_cfg)
            want = tree_leaves(template)
            leaves = [np.asarray(z[f"leaf_{i:03d}"], np.float32) for i in range(len(want))]
            for got, w in zip(leaves, want):
                if got.shape != tuple(w.shape):
                    raise ValueError(f"leaf shape {got.shape} != expected {tuple(w.shape)}")
            params = tree_unflatten(template, [torch.from_numpy(a).to(device) for a in leaves])
            est = NPEstimator(
                model=str(meta["model"]),
                num_days=int(meta["num_days"]),
                summary=summary,
                schedule=sched,
                npe=npe_cfg,
                param_names=tuple(meta["param_names"]),
                lows=lows,
                highs=np.asarray(z["highs"], np.float32),
                feat_mean=feat_mean,
                feat_std=np.asarray(z["feat_std"], np.float32),
                params=params,
                train_steps_done=int(meta["train_steps_done"]),
                train_sims=int(meta["train_sims"]),
                train_wall_s=float(meta["train_wall_s"]),
                final_loss=float("nan") if meta["final_loss"] is None
                else float(meta["final_loss"]),
            )
        except FileNotFoundError:
            raise
        except (zipfile.BadZipFile, OSError, KeyError, ValueError,
                TypeError, json.JSONDecodeError) as e:
            raise ValueError(
                f"corrupt or incomplete NPE estimator file {path!r} ({e}); "
                "it was probably truncated by an interrupted save — delete "
                "it to re-train from scratch"
            ) from e
        return est


# ------------------------------------------------------------------ training
def _train_setup(dataset: CountryData, cfg, prior: Optional[UniformBoxPrior]):
    """What train_npe and run_npe share: (spec, prior, mcfg, mobility,
    summary, npe_cfg). Checks the dataset against the model as
    make_simulator does."""
    spec = get_model(cfg.model)
    if not dataset.compatible_with(spec):
        raise ValueError(
            f"dataset {dataset.name!r} holds {dataset.model!r} series; model "
            f"{spec.name!r} observes different channels"
        )
    prior = prior or schedule_prior(spec, cfg.schedule)
    mcfg = dataset.model_config(cfg.num_days)
    mob = resolved_mobility(cfg, spec)
    return spec, prior, mcfg, mob, cfg.summary_spec, resolve_npe_config(cfg.npe)


def _make_train_step(spec, prior, mcfg, schedule, summary, mobility,
                     npe_cfg: NPEConfig, opt_cfg: AdamWConfig,
                     lows, highs, feat_mean, feat_std, device):
    """One training step on `device`: simulate a fresh batch of pairs (no
    gradient), then one AdamW step on the MDN's negative log-likelihood,
    its gradients from autograd. Returns (params, opt_state, loss) with the
    loss a tensor on the device."""
    n_params = int(lows.shape[0])
    lo = torch.as_tensor(lows, dtype=torch.float32, device=device)
    width = torch.as_tensor(np.maximum(highs - lows, 1e-6), dtype=torch.float32,
                            device=device)
    mu_x = torch.as_tensor(feat_mean, dtype=torch.float32, device=device)
    sd_x = torch.as_tensor(feat_std, dtype=torch.float32, device=device)

    def loss_fn(params, theta, feats):
        x = (feats - mu_x) / sd_x
        t_std = (theta - lo) / width
        return -torch.mean(mdn_log_prob(params, x, t_std, npe_cfg, n_params))

    def step(params, opt_state, prior_seed: int, sim_seed: int):
        with torch.no_grad():
            theta = prior.sample(prior_seed, npe_cfg.train_batch, device)
            feats = engine.simulate_features(spec, theta, sim_seed, mcfg, schedule, None,
                                             summary, mobility)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), theta, feats)
        grads = torch.autograd.grad(loss, leaves)
        params, opt_state, _ = adamw_update(tree_unflatten(params, leaves),
                                            tree_unflatten(params, grads), opt_state, opt_cfg)
        return params, opt_state, loss.detach()

    return step


def _pilot_stats(spec, prior, mcfg, schedule, summary, mobility,
                 npe_cfg: NPEConfig, seed: int, device):
    """Feature standardization (mean, population std floored at 1e-3) from
    one prior-predictive pilot batch on `device`, returned to the host once.

    Computed once at training time and frozen into the estimator:
    fine-tuning keeps the same normalization, so the trained trunk stays
    valid."""
    theta = prior.sample(krng.stream_seed(seed, 0, _PILOT_SALT), npe_cfg.n_pilot, device)
    feats = engine.simulate_features(spec, theta, krng.stream_seed(seed, 1, _PILOT_SALT),
                                     mcfg, schedule, None, summary, mobility)
    mean = feats.mean(dim=0)
    std = torch.clamp(feats.std(dim=0, unbiased=False), min=1e-3)
    return mean.cpu().numpy(), std.cpu().numpy()


@torch.no_grad()
def train_npe(
    dataset: CountryData,
    cfg,
    seed: int = 0,
    prior: Optional[UniformBoxPrior] = None,
    verbose: bool = False,
    device="cuda",
) -> NPEstimator:
    """Train an amortized posterior for `ABCConfig(backend="npe")` on
    `device`.

    Every step simulates a fresh `npe.train_batch` of (theta, features)
    pairs: `n_pilot + train_steps * train_batch` simulations in all, paid
    once; afterwards every posterior query is a forward pass.
    """
    t0 = time.time()
    device = resolve_device(device)
    spec, prior, mcfg, mob, summary, npe_cfg = _train_setup(dataset, cfg, prior)
    schedule = cfg.schedule
    lows = np.asarray(prior.lows, np.float32)
    highs = np.asarray(prior.highs, np.float32)
    feat_mean, feat_std = _pilot_stats(spec, prior, mcfg, schedule, summary, mob, npe_cfg,
                                       seed, device)
    params = mdn_init(krng.stream_seed(seed, 0, PRIOR_STREAM), feat_mean.shape[0],
                      lows.shape[0], npe_cfg, device)
    opt_cfg = AdamWConfig(
        lr=npe_cfg.lr, weight_decay=npe_cfg.weight_decay,
        warmup_steps=max(1, npe_cfg.train_steps // 20),
        total_steps=npe_cfg.train_steps,
    )
    step = _make_train_step(spec, prior, mcfg, schedule, summary, mob, npe_cfg, opt_cfg,
                            lows, highs, feat_mean, feat_std, device)
    opt_state = adamw_init(params)
    loss = None
    with torch.enable_grad():
        for i in range(npe_cfg.train_steps):
            params, opt_state, loss = step(params, opt_state, *step_seeds(seed, i + 1))
            if verbose and (i + 1) % 100 == 0:
                print(f"[npe] step {i + 1}/{npe_cfg.train_steps}: nll {float(loss):.3f}")
    return NPEstimator(
        model=spec.name,
        num_days=cfg.num_days,
        summary=summary,
        schedule=schedule,
        npe=npe_cfg,
        param_names=tuple(run_param_names(cfg, spec)),
        lows=lows,
        highs=highs,
        feat_mean=feat_mean,
        feat_std=feat_std,
        params=params,
        train_steps_done=npe_cfg.train_steps,
        train_sims=npe_cfg.n_pilot + npe_cfg.train_steps * npe_cfg.train_batch,
        train_wall_s=time.time() - t0,
        final_loss=float(loss) if loss is not None else float("nan"),
    )


@torch.no_grad()
def fine_tune(
    est: NPEstimator,
    dataset: CountryData,
    seed: int = 0,
    steps: Optional[int] = None,
    verbose: bool = False,
) -> NPEstimator:
    """Continue training an estimator for a few steps on fresh simulations,
    on the estimator's device; `est` itself is left as it was.

    The serving re-fit: when a dataset's content moves, the posterior
    already conditions on the new series at query time, and a short
    fine-tune keeps the density head sharp against simulator drift (e.g.
    new dataset scalars). `steps` defaults to `est.npe.fine_tune_steps`; 0
    returns `est` itself. The feature standardization and the prior box
    stay as trained. As in `repro`, the step is built with no mobility
    override (a regional model's own matrix).
    """
    steps = est.npe.fine_tune_steps if steps is None else int(steps)
    if steps == 0:
        return est
    t0 = time.time()
    spec = get_model(est.model)
    if not dataset.compatible_with(spec):
        raise ValueError(
            f"dataset {dataset.name!r} holds {dataset.model!r} series; "
            f"estimator was trained for {est.model!r}"
        )
    prior = UniformBoxPrior(highs=tuple(est.highs), lows=tuple(est.lows))
    mcfg = dataset.model_config(est.num_days)
    opt_cfg = AdamWConfig(
        lr=est.npe.fine_tune_lr, weight_decay=est.npe.weight_decay,
        warmup_steps=1, total_steps=max(steps, 1),
    )
    step_fn = _make_train_step(spec, prior, mcfg, est.schedule, est.summary, None, est.npe,
                               opt_cfg, est.lows, est.highs, est.feat_mean, est.feat_std,
                               est.device)
    params, opt_state, loss = est.params, adamw_init(est.params), None
    with torch.enable_grad():
        for i in range(steps):
            params, opt_state, loss = step_fn(params, opt_state, *step_seeds(seed, i + 1))
    if verbose:
        print(f"[npe] fine-tuned {steps} steps: nll {float(loss):.3f}")
    return dataclasses.replace(
        est,
        params=params,
        train_steps_done=est.train_steps_done + steps,
        train_sims=est.train_sims + steps * est.npe.train_batch,
        train_wall_s=est.train_wall_s + (time.time() - t0),
        final_loss=float(loss) if loss is not None else est.final_loss,
    )


def run_npe(
    dataset: CountryData,
    cfg,
    seed: int = 0,
    prior: Optional[UniformBoxPrior] = None,
    verbose: bool = False,
    device="cuda",
) -> Posterior:
    """The `run_abc` face of the NPE backend: train on `device`, then sample
    `cfg.target_accepted` draws for the dataset's observed series. The
    `Posterior` carries the training simulations in `simulations` and the
    wall time with the training in `wall_time_s`."""
    t0 = time.time()
    est = train_npe(dataset, cfg, seed, prior=prior, verbose=verbose, device=device)
    post = est.sample_posterior(dataset.observed[:, : cfg.num_days], cfg.target_accepted,
                                seed=seed)
    post.wall_time_s = time.time() - t0
    return post
