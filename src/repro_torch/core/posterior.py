"""Accepted-sample containers and posterior summaries (paper §5, Table 8).

The port's copy of `repro.core.posterior`: the same `.npz` fields, so a
file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.ioutils import atomic_write


@dataclasses.dataclass
class Posterior:
    """A set of accepted ABC posterior samples."""

    theta: np.ndarray  # [N, p]
    distances: np.ndarray  # [N]
    tolerance: float
    param_names: Sequence[str]
    #: bookkeeping from the run
    runs: int = 0
    simulations: int = 0
    wall_time_s: float = 0.0
    #: optional importance weights [N] (SMC populations); persisted so a
    #: stored posterior can warm-start a re-fit with its weighted population
    weights: Optional[np.ndarray] = None

    def __post_init__(self):
        self.theta = np.asarray(self.theta, np.float32).reshape(
            -1, len(self.param_names)
        )
        self.distances = np.asarray(self.distances, np.float32).reshape(-1)
        assert self.theta.shape[0] == self.distances.shape[0]
        if self.weights is not None:
            self.weights = np.asarray(self.weights, np.float32).reshape(-1)
            assert self.weights.shape[0] == self.theta.shape[0]

    def __len__(self) -> int:
        return int(self.theta.shape[0])

    @property
    def acceptance_rate(self) -> float:
        return len(self) / max(self.simulations, 1)

    def mean(self) -> Dict[str, float]:
        return {
            name: float(m)
            for name, m in zip(self.param_names, self.theta.mean(axis=0))
        }

    def std(self) -> Dict[str, float]:
        return {
            name: float(s)
            for name, s in zip(self.param_names, self.theta.std(axis=0))
        }

    def quantiles(self, qs=(0.05, 0.5, 0.95)) -> Dict[str, Dict[float, float]]:
        out: Dict[str, Dict[float, float]] = {}
        for j, name in enumerate(self.param_names):
            out[name] = {
                float(q): float(np.quantile(self.theta[:, j], q)) for q in qs
            }
        return out

    def histogram(self, param: str, bins: int = 20):
        j = list(self.param_names).index(param)
        return np.histogram(self.theta[:, j], bins=bins)

    def top(self, k: int) -> "Posterior":
        """k lowest-distance samples."""
        idx = np.argsort(self.distances)[:k]
        return dataclasses.replace(
            self, theta=self.theta[idx], distances=self.distances[idx],
            weights=None if self.weights is None else self.weights[idx],
        )

    def summary_table(self) -> str:
        mu, sd = self.mean(), self.std()
        header = f"{'param':>8} | {'mean':>10} | {'std':>10}"
        rows = [header, "-" * len(header)]
        for name in self.param_names:
            rows.append(f"{name:>8} | {mu[name]:>10.4f} | {sd[name]:>10.4f}")
        rows.append(
            f"N={len(self)} eps={self.tolerance:g} runs={self.runs} "
            f"sims={self.simulations} accept_rate={self.acceptance_rate:.3e} "
            f"wall={self.wall_time_s:.2f}s"
        )
        return "\n".join(rows)

    def save(self, path: str) -> None:
        """Atomic save (`repro_torch.ioutils.atomic_write`): a crash
        mid-write never leaves a truncated file at `path`, and the exact
        path given is kept."""
        arrays = dict(
            theta=self.theta,
            distances=self.distances,
            tolerance=self.tolerance,
            param_names=np.asarray(self.param_names),
            runs=self.runs,
            simulations=self.simulations,
            wall_time_s=self.wall_time_s,
        )
        if self.weights is not None:
            arrays["weights"] = self.weights
        with atomic_write(path, "wb") as f:
            np.savez(f, **arrays)

    _REQUIRED_KEYS = (
        "theta", "distances", "tolerance", "param_names", "runs",
        "simulations", "wall_time_s",
    )

    @staticmethod
    def load(path: str) -> "Posterior":
        """Load a saved posterior from the exact path given to save().

        Corrupt or truncated files raise ValueError with a remediation hint
        instead of a bare zipfile/KeyError deep inside a serving loop; a
        missing file is NOT corruption — FileNotFoundError propagates."""
        try:
            z = np.load(path, allow_pickle=False)
            missing = [k for k in Posterior._REQUIRED_KEYS if k not in z.files]
            if missing:
                raise ValueError(f"missing arrays {missing}")
            theta = np.asarray(z["theta"], np.float32)
            distances = np.asarray(z["distances"], np.float32)
            names = [str(s) for s in z["param_names"]]
            if theta.ndim != 2 or distances.shape != (theta.shape[0],):
                raise ValueError(
                    f"inconsistent shapes theta={theta.shape} "
                    f"distances={distances.shape}"
                )
            if len(names) != theta.shape[1]:
                raise ValueError(
                    f"{len(names)} param names for theta width {theta.shape[1]}"
                )
            return Posterior(
                theta=theta,
                distances=distances,
                tolerance=float(z["tolerance"]),
                param_names=names,
                runs=int(z["runs"]),
                simulations=int(z["simulations"]),
                wall_time_s=float(z["wall_time_s"]),
                weights=np.asarray(z["weights"], np.float32)
                if "weights" in z.files
                else None,
            )
        except FileNotFoundError:
            raise
        except (zipfile.BadZipFile, OSError, KeyError, ValueError) as e:
            raise ValueError(
                f"corrupt or incomplete posterior file {path!r} ({e}); it was "
                "probably truncated by an interrupted save — delete it and "
                "re-fit"
            ) from e
