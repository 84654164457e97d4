"""The compaction kernel of the device wave loop (`kernels.compact`,
`csrc/abc_compact.cu`) on the card (marker `gpu`; skips without one).

`core.abc.compact_accepted` takes the kernel for CUDA tensors and the plain
PyTorch copy for CPU tensors. Each case hands both the same buffers and
wave and holds the kernel's rows [0, capacity) and new fill to the plain
path's bit for bit: accepted rows in stream order from the fill on, the
excess past the capacity dropped, every other row untouched.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_compact_gpu.py
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import abc as tabc
from repro_torch.core import smc as tsmc
from repro_torch.epi import data
from repro_torch.epi.models import get_model
from repro_torch.kernels import compact
from repro_torch.runtime import trace

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the port's kernels")
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint8)


def _wave(seed: int, batch: int, p: int, share: float, capacity: int, fill: int,
          gated: bool = False, offset: int = 0):
    """Buffers of `capacity + 1` rows (a sentinel in every row), `fill`, and
    a wave of `batch` rows of which a `share` is accepted; `offset` leaves
    the accept mask at that many bytes into its storage."""
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((batch, p)).astype(np.float32)
    dist = rng.random(batch).astype(np.float32)
    mask = np.zeros(batch + offset, bool)
    mask[offset:] = rng.random(batch) < share
    if gated:
        mask[:] = False
    return dict(th_buf=np.full((capacity + 1, p), -7.5, np.float32),
                d_buf=np.full((capacity + 1,), np.inf, np.float32),
                fill=np.array([fill], np.int64), theta=theta, dist=dist, accept=mask,
                offset=offset, capacity=capacity)


def _compare(cuda, w):
    """The kernel's (rows, new fill) against the plain path's on the same
    wave; returns the number accepted."""
    cap, off = w["capacity"], w["offset"]
    args = {k: torch.from_numpy(w[k].copy()) for k in ("th_buf", "d_buf", "fill", "theta", "dist")}
    accept = torch.from_numpy(w["accept"].copy())
    p_th, p_d, p_fill = tabc.compact_accepted(args["th_buf"], args["d_buf"], args["fill"],
                                              args["theta"], args["dist"], accept[off:], cap)
    dev = {k: v.to(cuda) for k, v in args.items()}
    dev_accept = accept.to(cuda)[off:]
    launches = tabc.COMPACT_KERNEL_LAUNCHES
    k_th, k_d, k_fill = tabc.compact_accepted(dev["th_buf"], dev["d_buf"], dev["fill"],
                                              dev["theta"], dev["dist"], dev_accept, cap)
    torch.cuda.synchronize()
    assert tabc.COMPACT_KERNEL_LAUNCHES == launches + 1
    assert not compact._WORDS[(cuda.index, torch.cuda.current_stream(cuda).cuda_stream)].any()
    assert k_th is dev["th_buf"] and k_d is dev["d_buf"]
    assert k_fill is not dev["fill"] and int(dev["fill"]) == int(w["fill"][0])
    assert k_fill.dtype == torch.int64 and tuple(k_fill.shape) == (1,)
    n = int(w["accept"][off:].sum())
    assert int(k_fill) == int(p_fill) == int(w["fill"][0]) + n
    np.testing.assert_array_equal(_bits(k_th[:cap]), _bits(p_th[:cap]))
    np.testing.assert_array_equal(_bits(k_d[:cap]), _bits(p_d[:cap]))
    return n


#: name: (batch, p, accepted share, capacity, fill, gated, mask offset)
EDGE_CASES = {
    "no_accepts": (4096, 8, 0.0, 100, 3, False, 0),
    "gated": (1_000_000, 8, 1e-3, 1_000_100, 0, True, 0),
    "fills_capacity_exactly": (4096, 8, 1.0, 4100, 4, False, 0),
    "overflow_drops_the_excess": (10_000, 8, 0.3, 2000, 5, False, 0),
    "fill_past_the_capacity": (10_000, 8, 0.3, 2000, 2500, False, 0),
    "fill_not_zero": (50_000, 8, 0.01, 50_100, 37, False, 0),
    "ragged_tail": (1_000_003, 8, 1e-3, 1_000_103, 11, False, 0),
    "unaligned_mask": (100_001, 8, 0.02, 100_101, 2, False, 1),
    "one_row": (1, 8, 1.0, 101, 0, False, 0),
    "regional_p": (1_000_000, 4, 1e-4, 1_000_100, 0, False, 0),
    "scheduled_p": (1_000_000, 10, 1e-4, 1_000_100, 0, False, 0),
    "p_past_a_warp": (20_000, 40, 0.05, 20_100, 9, False, 0),
    # SMC's theta-in rounds: n_particles + batch rows, the default 256 + 4096,
    # and 1,000 particles at 100,000 proposals
    "smc_default": (4096, 8, 0.05, 256 + 4096, 40, False, 0),
    "smc_100k": (100_000, 8, 0.004, 1000 + 100_000, 300, False, 0),
}


@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_equals_the_plain_compaction(cuda, case):
    batch, p, share, cap, fill, gated, off = EDGE_CASES[case]
    n = _compare(cuda, _wave(11, batch, p, share, cap, fill, gated, off))
    if case in ("no_accepts", "gated"):
        assert n == 0
    if case == "fills_capacity_exactly":
        assert fill + n == cap
    if case in ("overflow_drops_the_excess", "fill_past_the_capacity"):
        assert fill + n > cap


@pytest.mark.parametrize("batch", [1_000_000, 4_000_000])
@pytest.mark.parametrize("share", [1e-5, 0.5])
@pytest.mark.parametrize("p", [8, 4])
def test_random_masks_at_the_main_paths_batches(cuda, batch, share, p):
    """Sparse (1e-5, the benchmark's quantile) and dense masks at 1,000,000
    rows and at `_AUTO_DEVICE_MAX_ROWS`, which is 4,000,000."""
    assert tabc._AUTO_DEVICE_MAX_ROWS == 4_000_000
    for seed, fill in ((1, 0), (2, 57)):
        _compare(cuda, _wave(seed, batch, p, share, batch + 100, fill))


def test_launches_of_other_sizes_and_streams_in_turn(cuda):
    """The status words are reused launch after launch, grown for a larger
    batch, and kept apart a stream: every launch of a sequence that changes
    its batch and its stream equals the plain path and leaves its words
    zero."""
    sizes = [4096, 1_000_000, 8192, 4_000_000, 1, 1_000_000, 4096, 4_000_000, 12_345]
    side = torch.cuda.Stream(cuda)
    for i, batch in enumerate(sizes):
        w = _wave(100 + i, batch, 8, 0.01, batch + 64, i)
        if i % 3 == 2:
            side.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(side):
                _compare(cuda, w)
        else:
            _compare(cuda, w)
    assert len({k for k in compact._WORDS if k[0] == cuda.index}) >= 2


def test_a_cuda_graph_replays_the_launch(cuda):
    """A launch keeps no state on the host: one captured in a CUDA graph and
    replayed on other waves, copied into its inputs, equals the plain path
    every time (sparse, no accepts, dense, an overflow past the capacity)
    and leaves its words zero."""
    cap = 100_100
    waves = [_wave(40 + i, 100_000, 8, share, cap, fill)
             for i, (share, fill) in enumerate(((1e-3, 0), (0.0, 5), (0.5, 3),
                                                (0.2, cap - 17), (1e-4, 99)))]
    keys = ("th_buf", "d_buf", "fill", "theta", "dist", "accept")
    static = {k: torch.from_numpy(waves[0][k]).to(cuda) for k in keys}
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # the warm-up makes the side stream's words
        tabc.compact_accepted(*(static[k] for k in keys), cap)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        _, _, new_fill = tabc.compact_accepted(*(static[k] for k in keys), cap)
    for w in waves:
        want = tabc.compact_accepted(*(torch.from_numpy(w[k].copy()) for k in keys), cap)
        for k in keys:
            static[k].copy_(torch.from_numpy(w[k]))
        graph.replay()
        torch.cuda.synchronize()
        assert int(new_fill) == int(want[2]) == int(w["fill"][0]) + int(w["accept"].sum())
        np.testing.assert_array_equal(_bits(static["th_buf"][:cap]), _bits(want[0][:cap]))
        np.testing.assert_array_equal(_bits(static["d_buf"][:cap]), _bits(want[1][:cap]))
        assert not compact._WORDS[(cuda.index, side.cuda_stream)].any()


def test_a_compaction_is_one_span_and_makes_no_host_sync(cuda):
    """On the card `abc.compact` still wraps one call, which enqueues under
    set_sync_debug_mode("error")."""
    w = _wave(5, 100_000, 8, 1e-3, 100_100, 0)
    t = {k: torch.from_numpy(w[k]).to(cuda) for k in ("th_buf", "d_buf", "fill", "theta",
                                                     "dist", "accept")}
    torch.cuda.synchronize()
    trace.disable()
    trace.clear()
    trace.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, new_fill = tabc.compact_accepted(t["th_buf"], t["d_buf"], t["fill"], t["theta"],
                                               t["dist"], t["accept"], w["capacity"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.disable()
    spans = trace.records()
    trace.clear()
    assert [s[0] for s in spans] == ["abc.compact"]
    assert int(new_fill) == int(w["accept"].sum())


def test_wrapper_refuses_what_the_kernel_does_not_take_on_the_card(cuda):
    w = _wave(6, 4096, 8, 0.1, 4196, 0)
    t = {k: torch.from_numpy(w[k]).to(cuda) for k in ("th_buf", "d_buf", "fill", "theta",
                                                     "dist", "accept")}

    def args(**over):
        return {**t, "capacity": w["capacity"], **over}

    with pytest.raises(ValueError, match="fill must be"):
        compact.compact_rows(**args(fill=t["fill"].cpu()))
    with pytest.raises(ValueError, match="theta must be"):
        compact.compact_rows(**args(theta=t["theta"].t().contiguous().t()))
    with pytest.raises(ValueError, match="accept must be"):
        compact.compact_rows(**args(accept=t["accept"].to(torch.uint8)))


def test_a_device_loop_posterior_through_the_kernel_equals_the_host_loop(cuda):
    """At the benchmark's 1,000,000 a wave and 1e-5 quantile: the device
    loop's posterior, whose compactions all took the kernel (16 a segment),
    is the host loop's bit for bit."""
    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(batch_size=1_000_000, chunk_size=10_000, num_days=49, tolerance=1.0,
                         target_accepted=30, max_runs=40)
    sim = tabc.make_simulator(ds, cfg, cuda)
    eps = tabc.calibrate_tolerance(ds, cfg, seed=4, quantile=1e-5, n_pilot=1_000_000,
                                   simulator=sim)
    cfg = dataclasses.replace(cfg, tolerance=eps)
    host = tabc.run_abc(ds, dataclasses.replace(cfg, wave_loop="host"), seed=9, device=cuda)
    launches, syncs = tabc.COMPACT_KERNEL_LAUNCHES, tabc.HOST_SYNCS
    runner = tabc.make_wave_runner(get_model("siard").prior(), sim,
                                   dataclasses.replace(cfg, wave_loop="device"))
    dev = tabc.run_abc(ds, dataclasses.replace(cfg, wave_loop="device"), seed=9, device=cuda,
                       wave_runner=runner)
    segments = tabc.HOST_SYNCS - syncs
    assert segments >= 1
    assert tabc.COMPACT_KERNEL_LAUNCHES - launches == tabc.SEGMENT_WAVES * segments
    assert (dev.runs, dev.simulations, len(dev)) == (host.runs, host.simulations, len(host))
    assert len(host) >= 30 and host.runs >= 2
    np.testing.assert_array_equal(dev.theta.view(np.uint32), host.theta.view(np.uint32))
    np.testing.assert_array_equal(dev.distances.view(np.uint32), host.distances.view(np.uint32))


def test_an_smc_round_on_the_card_takes_the_kernel(cuda):
    """The SMC device round compacts through the kernel: its rows are the
    first accepted proposals, at or below eps."""
    ds = data.get_dataset("italy", num_days=30)
    spec = get_model("siard")
    prior = spec.prior()
    cfg = tsmc.SMCConfig(n_particles=64, batch_size=4096, num_days=30, wave_loop="device")
    sim = tabc.make_simulator(ds, tabc.ABCConfig(batch_size=4096, chunk_size=4096,
                                                 num_days=30), cuda)
    particles = prior.sample(1, 64).numpy()
    weights = np.full(64, 1 / 64)
    sigma = np.full(8, 0.02, np.float32)
    launches = tabc.COMPACT_KERNEL_LAUNCHES
    th, d, accepted, waves = tsmc.make_smc_round_fn(sim, prior, cfg)(
        3, 1, particles, weights, sigma, 1e9, 8)
    assert tabc.COMPACT_KERNEL_LAUNCHES - launches >= waves >= 1
    assert len(th) == min(accepted, 64) and (d <= 1e9).all()
