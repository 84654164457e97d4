"""The port's counter-hash RNG twin against `repro.kernels.rng`.

The integer bits must agree exactly; the Box-Muller normals go through
`log` and `cos`, whose last ulps differ between XLA and PyTorch, so they are
held at atol=1e-6 (|z| < 5.8, where one ulp is below 4.8e-7).
"""

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import rng as jrng
from repro_torch.kernels import rng as trng

torch.set_num_threads(1)

N = 1 << 20


def _words(seed: int):
    rs = np.random.default_rng(seed)
    return tuple(
        rs.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32) for _ in range(3)
    )


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


def test_hash_and_uniform_bits_equal_repro():
    s, i, c = _words(0)
    want = np.asarray(jrng.hash_u32(s, i, c)).astype(np.int64)
    got = trng.hash_u32(_t(s), _t(i), _t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    u_want = np.asarray(jrng.uniform_open(s, i, c))
    u_got = trng.uniform_open(_t(s), _t(i), _t(c)).numpy()
    np.testing.assert_array_equal(u_got, u_want)
    assert u_got.min() > 0.0 and u_got.max() <= 1.0


def test_fmix32_matches_repro_on_edge_words():
    x = np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                 np.uint32)
    want = np.asarray(jrng.fmix32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(trng.fmix32(_t(x)).numpy(), want)


def test_normals_close_to_repro():
    s, i, c = _words(1)
    c = c >> 1  # normal() uses counters 2c and 2c+1
    want = np.asarray(jrng.normal(s, i, c))
    got = trng.normal(_t(s), _t(i), _t(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(float(got.mean())) < 5e-3 and abs(float(got.std()) - 1.0) < 5e-3


def test_day_transition_ctr_and_hash_normals_layout():
    assert int(trng.day_transition_ctr(3, 4)) == 3 * 8 + 4
    idx = torch.arange(64)
    z = trng.hash_normals(9, idx, 5, 5)
    assert z.shape == (64, 5)
    for k in range(5):
        torch.testing.assert_close(
            z[:, k], trng.normal(9, idx, trng.day_transition_ctr(5, k)),
            rtol=0, atol=0)


def test_stream_seed_streams_differ_and_repeat():
    a = trng.stream_seed(7, 3, 0)
    assert a == trng.stream_seed(7, 3, 0)
    assert len({a, trng.stream_seed(7, 3, 1), trng.stream_seed(7, 4, 0),
                trng.stream_seed(8, 3, 0)}) == 4
    assert 0 <= a < 2**32
