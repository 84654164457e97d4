"""Epidemiology workload configs of the port (counterpart of
`repro.configs.epi_abc` for what the port runs): `serving_demo` and
`npe_serving_demo` template the query server, `npe_demo` sizes the small
amortized-inference estimator (backend="npe"). The sizes are `repro`'s; the
simulation backend is the port's "cuda" (its plain version on the CPU)."""

import dataclasses

from repro_torch.core.abc import ABCConfig


@dataclasses.dataclass(frozen=True)
class ABCWorkload:
    name: str
    dataset: str
    abc: ABCConfig

    def load_dataset(self, num_days: int | None = None):
        """The dataset for this workload's model (the name alone would lose
        the model)."""
        from repro_torch.epi.data import get_dataset

        return get_dataset(self.dataset, num_days=num_days or self.abc.num_days,
                           model=self.abc.model)


def serving_demo(store_dir: str | None = None, data_dir: str | None = None):
    """A small `serve --epi` config: fast SMC fits on the device round, small
    forecast batches. Returns a `repro_torch.core.serving.ServeConfig`."""
    from repro_torch.core.serving import ServeConfig
    from repro_torch.core.smc import SMCConfig

    return ServeConfig(
        slots=4,
        forecast_particles=64,
        fit=SMCConfig(
            n_particles=64,
            batch_size=1024,
            n_rounds=2,
            quantile=0.5,
            num_days=15,
            backend="cuda",
            model="siard",
            wave_loop="device",
        ),
        data_dir=data_dir,
        store_dir=store_dir,
    )


def npe_demo(model: str = "sir", num_days: int = 15) -> ABCWorkload:
    """A small amortized-inference workload: an NPE estimator trained on
    about 1e5 simulations (300 steps of 256 and a pilot of 512). Production
    fits raise `train_steps`, `train_batch` and `hidden`."""
    from repro_torch.core.npe import NPEConfig

    return ABCWorkload(
        name=f"epi-npe-demo-{model}",
        dataset="synthetic_small",
        abc=ABCConfig(
            target_accepted=256,
            num_days=num_days,
            backend="npe",
            model=model,
            npe=NPEConfig(
                train_steps=300,
                train_batch=256,
                hidden=64,
                n_components=4,
                n_pilot=512,
                fine_tune_steps=50,
            ),
        ),
    )


def npe_serving_demo(store_dir: str | None = None, data_dir: str | None = None):
    """`serving_demo` with the amortized fit backend: the first query of a
    (model, summary, schedule) trains the estimator; every later dataset
    version is a fine-tune and a forward pass, never a wave campaign."""
    from repro_torch.core.npe import NPEConfig

    return dataclasses.replace(
        serving_demo(store_dir=store_dir, data_dir=data_dir),
        fit_backend="npe",
        npe=NPEConfig(train_steps=120, train_batch=128, n_pilot=256, fine_tune_steps=20),
    )
