"""The port's CUDA kernel on the card (marker `gpu`; skips without one).

Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether a card is there is decided inside the `cuda` fixture, never at
import, so every worker collects the same tests.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import abc as tabc
from repro_torch.core.priors import paper_prior
from repro_torch.core.summaries import summary_pairs
from repro_torch.epi import data
from repro_torch.kernels import abc_sim, ops, ref
from repro_torch.kernels import rng as krng

pytestmark = pytest.mark.gpu

PINS = os.path.join(os.path.dirname(__file__), "data", "r1_pins.npz")
BAR = dict(rtol=2e-6, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the port's kernels")
    return torch.device("cuda", 0)


def _small_kw():
    pop, a0, r0, d0, _ = data.SYNTH_SMALL_META
    return dict(population=pop, a0=a0, r0=r0, d0=d0)


def _kernel_and_plain(cuda, theta, seed, obs, **kw):
    th = torch.as_tensor(np.asarray(theta, np.float32), device=cuda)
    ob = torch.as_tensor(np.asarray(obs, np.float32), device=cuda)
    launches, calls = abc_sim.LAUNCHES, ref.CALLS
    d_k = ops.abc_sim_distance(th, seed, ob, **kw)
    assert (abc_sim.LAUNCHES, ref.CALLS) == (launches + 1, calls)
    d_p = ref.abc_sim_distance_ref(th, seed, ob, **kw)
    return d_k.cpu().numpy(), d_p.cpu().numpy()


def test_kernel_matches_plain_and_pins(cuda):
    pins = np.load(PINS)
    d_k, d_p = _kernel_and_plain(cuda, pins["siard/theta"], 123,
                                 pins["siard/observed"], **_small_kw())
    np.testing.assert_allclose(d_k, d_p, **BAR)
    np.testing.assert_allclose(d_k, pins["siard/pallas"], **BAR)
    np.testing.assert_allclose(d_k, pins["siard/oracle"], **BAR)


@pytest.mark.parametrize("summary,distance", summary_pairs())
def test_kernel_matches_plain_every_flat_pair(cuda, summary, distance):
    ds = data.get_dataset("synthetic_small", num_days=49)
    theta = paper_prior().sample(4, 1024, "cpu").numpy()
    d_k, d_p = _kernel_and_plain(cuda, theta, 7, ds.observed, summary=summary,
                                 distance=distance, **_small_kw())
    np.testing.assert_allclose(d_k, d_p, **BAR)


def test_kernel_is_bitwise_block_invariant_and_counts_launches(cuda):
    ds = data.get_dataset("italy", num_days=49)
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    theta = paper_prior().sample(5, 10_000, cuda)
    obs = torch.as_tensor(ds.observed, device=cuda)
    before = abc_sim.LAUNCHES
    outs = [ops.abc_sim_distance(theta, 3, obs, block=b, **kw) for b in (64, 128, 256)]
    assert abc_sim.LAUNCHES == before + 3
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_rng_kernel_bits_exact(cuda):
    bits = abc_sim.rng_normals(9, 4096, 10, bits=True, device=cuda)
    idx = torch.arange(4096, device=cuda)[:, None]
    ctr = torch.arange(10, device=cuda)[None, :]
    assert torch.equal(bits, krng.hash_u32(9, idx, ctr))
    z = abc_sim.rng_normals(9, 4096, 10, device=cuda)
    torch.testing.assert_close(z, krng.normal(9, idx, ctr), rtol=0, atol=1e-6)


def test_prior_draws_equal_on_cpu_and_card(cuda):
    prior = paper_prior()
    assert torch.equal(prior.sample(17, 100_000, cuda).cpu(), prior.sample(17, 100_000))


def test_run_abc_on_the_card_goes_through_the_kernel(cuda):
    ds = data.get_dataset("synthetic_small", num_days=20)
    cfg = tabc.ABCConfig(batch_size=8192, chunk_size=1024, num_days=20,
                         tolerance=2e4, target_accepted=50, max_runs=20)
    launches, calls = abc_sim.LAUNCHES, ref.CALLS
    post = tabc.run_abc(ds, cfg, seed=0, device=cuda)
    assert abc_sim.LAUNCHES - launches == post.runs and ref.CALLS == calls
    again = tabc.run_abc(ds, cfg, seed=0, device=cuda)
    np.testing.assert_array_equal(post.theta, again.theta)


def test_make_abc_sim_on_the_card_matches_per_call_lowering(cuda):
    ds = data.get_dataset("synthetic_small", num_days=49)
    obs = torch.as_tensor(ds.observed, device=cuda)
    theta = paper_prior().sample(6, 4096, cuda)
    sim = ops.make_abc_sim(obs, summary="weekly", distance="normalized_euclidean",
                           **_small_kw())
    for seed in (0, 11, 0xFFFFFFFF):
        launches = abc_sim.LAUNCHES
        got = sim(theta, seed)
        assert abc_sim.LAUNCHES == launches + 1
        assert torch.equal(got, ops.abc_sim_distance(
            theta, seed, obs, summary="weekly", distance="normalized_euclidean",
            **_small_kw()))
