"""The port's two small facades against `repro`'s: `core/distances.py`
against `repro.core.distances`, and `epi/model.py`, the paper-SIARD facade,
against `repro.epi.model` (on the same seeded numpy inputs, rtol 1e-6) and
against the port's own engine (bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.epi import model as jmodel
from repro.epi.spec import EpiModelConfig as JConfig
from repro_torch.core import distances as tdist
from repro_torch.epi import engine
from repro_torch.epi import model as tmodel
from repro_torch.epi.spec import EpiModelConfig
from repro_torch.kernels import ref

torch.set_num_threads(1)

RTOL = 1e-6
CFG = dict(population=1e6, num_days=14, a0=100.0, r0=5.0, d0=1.0)


def _theta(rng, batch):
    return (rng.uniform(0.0, 1.0, (batch, 8)) * np.asarray(tmodel.PRIOR_HIGHS)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(tdist.DISTANCES))
def test_distances_match_repro(name):
    rng = np.random.default_rng(5)
    sim = rng.gamma(2.0, 300.0, (64, 3, 21)).astype(np.float32)
    obs = rng.gamma(2.0, 300.0, (3, 21)).astype(np.float32)
    got = tdist.DISTANCES[name](torch.from_numpy(sim), torch.from_numpy(obs)).numpy()
    want = np.asarray(jdist.DISTANCES[name](jnp.asarray(sim), jnp.asarray(obs)))
    assert got.shape == (64,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_distance_names_are_repros():
    assert list(tdist.DISTANCES) == list(jdist.DISTANCES)
    assert tdist.euclidean_distance(torch.ones((2, 3, 4)), torch.ones((3, 4))).tolist() == [0, 0]


def test_model_constants_are_repros():
    for name in ("N_PARAMS", "N_STATE", "N_TRANSITIONS", "N_OBSERVED", "PARAM_NAMES",
                 "STATE_NAMES", "PRIOR_HIGHS", "OBSERVED_IDX"):
        assert getattr(tmodel, name) == getattr(jmodel, name), name


def test_hazards_initial_state_and_step_match_repro():
    rng = np.random.default_rng(11)
    theta = _theta(rng, 256)
    cfg_t, cfg_j = EpiModelConfig(**CFG), JConfig(**CFG)
    s_t = tmodel.initial_state(torch.from_numpy(theta), cfg_t)
    s_j = jmodel.initial_state(jnp.asarray(theta), cfg_j)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL)
    # a state away from the start, shared by both
    state = (rng.uniform(0.0, 1.0, (256, 6)) * np.asarray([9e5, 2e3, 1e3, 5e2, 1e2, 3e2])
             ).astype(np.float32)
    h_t = tmodel.hazards(torch.from_numpy(state), torch.from_numpy(theta), 1e6)
    h_j = jmodel.hazards(jnp.asarray(state), jnp.asarray(theta), 1e6)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=RTOL)
    ard = state[:, 2] + state[:, 3] + state[:, 4]
    np.testing.assert_allclose(
        tmodel.infection_rate(torch.from_numpy(theta), torch.from_numpy(ard)).numpy(),
        np.asarray(jmodel.infection_rate(jnp.asarray(theta), jnp.asarray(ard))), rtol=RTOL)
    noise = rng.standard_normal((256, 5)).astype(np.float32)
    n_t = tmodel.tau_leap_step(torch.from_numpy(state), torch.from_numpy(theta),
                               torch.from_numpy(noise), 1e6)
    n_j = jmodel.tau_leap_step(jnp.asarray(state), jnp.asarray(theta), jnp.asarray(noise), 1e6)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=RTOL)


def test_simulate_functions_are_the_engines_bitwise():
    theta = torch.from_numpy(_theta(np.random.default_rng(3), 128))
    cfg = EpiModelConfig(**CFG)
    seed = 0x5EED
    traj = tmodel.simulate(theta, seed, cfg)
    obs = tmodel.simulate_observed(theta, seed, cfg)
    want = engine.simulate_observed(tmodel.PAPER_MODEL, theta, seed, cfg)
    assert traj.shape == (128, 14, 6) and obs.shape == (128, 3, 14)
    assert torch.equal(obs, want)
    assert torch.equal(traj[:, :, list(tmodel.OBSERVED_IDX)].transpose(1, 2), want)
    observed = want[7]
    dist, final = tmodel.simulate_observed_lowmem(theta, seed, cfg, observed)
    assert torch.equal(final, traj[:, -1])
    assert torch.equal(dist, ref.abc_sim_distance_ref(theta, seed, observed, population=1e6,
                                                      a0=100.0, r0=5.0, d0=1.0))
    assert float(dist[7]) == 0.0  # its own trajectory
