"""The port's CUDA kernels on the card (marker `gpu`; skips without one).

Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether a card is there is decided inside the `cuda` fixture, never at
import, so every worker collects the same tests.
"""

import ctypes
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import abc as tabc
from repro_torch.core import priors
from repro_torch.core.priors import UniformBoxPrior, paper_prior
from repro_torch.core.summaries import summary_pairs
from repro_torch.core.priors import schedule_prior
from repro_torch.epi import data
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import InterventionSchedule
from repro_torch.kernels import abc_sim, build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rng as krng

torch.set_num_threads(1)

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
    launches, calls = abc_sim.launches("distance"), ref.CALLS
    d_k = ops.abc_sim_distance(th, seed, ob, **kw)
    assert (abc_sim.launches("distance"), ref.CALLS) == (launches + 1, calls)
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
    before = abc_sim.launches("distance")
    outs = [ops.abc_sim_distance(theta, 3, obs, block=b, **kw) for b in (64, 128, 256)]
    assert abc_sim.launches("distance") == before + 3
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_rng_kernel_bits_exact(cuda):
    bits = abc_sim.rng_normals(9, 4096, 10, bits=True, device=cuda)
    idx = torch.arange(4096, device=cuda)[:, None]
    ctr = torch.arange(10, device=cuda)[None, :]
    assert torch.equal(bits, krng.hash_u32(9, idx, ctr))
    z = abc_sim.rng_normals(9, 4096, 10, device=cuda)
    torch.testing.assert_close(z, krng.normal(9, idx, ctr), rtol=0, atol=1e-6)


def test_branch_free_box_muller_equals_the_precise_functions_on_every_uniform(cuda):
    """sqrt(-2 log u) and cos(2 pi u) of the kernel, without the precise
    functions' branches, equal sqrtf/logf and cosf bit for bit on all 2^24
    uniforms u = k * 2^-24 the hash can give."""
    launches = abc_sim.RNG_LAUNCHES
    assert abc_sim.unit_math_mismatches(cuda) == (0, 0)
    assert abc_sim.RNG_LAUNCHES == launches + 1


def test_prior_draws_equal_on_cpu_and_card(cuda):
    prior = paper_prior()
    assert torch.equal(prior.sample(17, 100_000, cuda).cpu(), prior.sample(17, 100_000))


def test_run_abc_on_the_card_goes_through_the_kernel(cuda):
    """One launch of the wave entry a wave that ran (and, on the device loop,
    fewer than SEGMENT_WAVES gated ones), and nothing else of the kernel's or
    the plain version's."""
    ds = data.get_dataset("synthetic_small", num_days=20)
    cfg = tabc.ABCConfig(batch_size=8192, chunk_size=1024, num_days=20,
                         tolerance=2e4, target_accepted=50, max_runs=20)
    launches, waves = abc_sim.launches("distance"), abc_sim.run_launches("wave")
    gated, calls = abc_sim.gated_launches("wave"), ref.CALLS
    post = tabc.run_abc(ds, cfg, seed=0, device=cuda)
    assert abc_sim.run_launches("wave") - waves == post.runs
    assert 0 <= abc_sim.gated_launches("wave") - gated < tabc.SEGMENT_WAVES
    assert (abc_sim.launches("distance"), ref.CALLS) == (launches, calls)
    again = tabc.run_abc(ds, cfg, seed=0, device=cuda)
    np.testing.assert_array_equal(post.theta, again.theta)


def test_run_abc_on_the_card_makes_no_host_prior_draw(cuda):
    """The pilot and every wave draw theta inside the kernel: no
    UniformBoxPrior.sample on the card, 1 + waves launches of the wave entry."""
    ds = data.get_dataset("synthetic_small", num_days=20)
    cfg = tabc.ABCConfig(batch_size=8192, chunk_size=1024, num_days=20, tolerance=1.0,
                         target_accepted=50, max_runs=20)
    draws, waves = priors.DEVICE_DRAWS, abc_sim.run_launches("wave")
    eps = tabc.calibrate_tolerance(ds, cfg, seed=1, quantile=0.01, n_pilot=8192, device=cuda)
    post = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps), seed=1, device=cuda)
    assert priors.DEVICE_DRAWS == draws
    assert abc_sim.run_launches("wave") - waves == 1 + post.runs
    assert len(post) >= 50 and (post.distances <= eps).all()


def test_wave_entry_draws_the_prior_bitwise_on_the_card(cuda):
    """theta from the kernel equals UniformBoxPrior.sample on the card and on
    the CPU, for a box with non-zero lows, at a batch no block size divides."""
    prior = UniformBoxPrior(highs=(0.9, 80.0, 2.0, 0.5, 1.0, 0.2, 1.0, 2.0),
                            lows=(0.1, 0.0, 0.5, 0.0, 0.0, 0.0, 0.2, 0.5))
    ds = data.get_dataset("italy", num_days=49)
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=cuda), **kw)
    theta, dist = sim.wave(prior, 0xFFFFFFFF, 5, 100_003)
    want = prior.sample(0xFFFFFFFF, 100_003, cuda)
    assert theta.shape == (100_003, 8) and theta.is_contiguous()
    assert torch.equal(theta, want) and torch.equal(theta.cpu(), prior.sample(0xFFFFFFFF, 100_003))
    assert torch.equal(dist, sim(want, 5))


@pytest.mark.parametrize("summary,distance", summary_pairs())
def test_wave_entry_equals_theta_in_and_plain_every_flat_pair(cuda, summary, distance):
    """Distances of the wave entry equal the theta-in entry's and the plain
    version's bitwise, at block 64, 128 and 256."""
    ds = data.get_dataset("synthetic_small", num_days=49)
    obs = torch.as_tensor(ds.observed, device=cuda)
    prior = paper_prior()
    theta = prior.sample(4, 1024, cuda)
    want = ref.abc_sim_distance_ref(theta, 7, obs, summary=summary, distance=distance,
                                    **_small_kw())
    want = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
    for block in (64, 128, 256):
        sim = ops.make_abc_sim(obs, summary=summary, distance=distance, block=block,
                               **_small_kw())
        waves, calls = abc_sim.launches("wave"), ref.CALLS
        got_theta, got = sim.wave(prior, 4, 7, 1024)
        assert (abc_sim.launches("wave"), ref.CALLS) == (waves + 1, calls)
        assert torch.equal(got_theta, theta) and torch.equal(got, want)
        d_in = sim(theta, 7)
        assert torch.equal(torch.where(torch.isnan(d_in), torch.full_like(d_in, float("inf")),
                                       d_in), got)


def test_wave_entry_turns_a_failed_simulation_into_inf(cuda):
    """A NaN bound makes theta and the simulation NaN: the wave entry writes
    +inf, the theta-in entry NaN, as on the CPU."""
    highs = list(paper_prior().highs)
    highs[2] = float("nan")
    prior = UniformBoxPrior(highs=tuple(highs))
    ds = data.get_dataset("synthetic_small", num_days=20)
    sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=cuda), **_small_kw())
    theta, dist = sim.wave(prior, 3, 4, 4096)
    assert torch.isnan(theta[:, 2]).all()
    assert torch.isinf(dist).all() and (dist > 0).all()
    assert torch.isnan(sim(theta, 4)).all()


def test_make_abc_sim_on_the_card_matches_per_call_lowering(cuda):
    ds = data.get_dataset("synthetic_small", num_days=49)
    obs = torch.as_tensor(ds.observed, device=cuda)
    theta = paper_prior().sample(6, 4096, cuda)
    sim = ops.make_abc_sim(obs, summary="weekly", distance="normalized_euclidean",
                           **_small_kw())
    for seed in (0, 11, 0xFFFFFFFF):
        launches = abc_sim.launches("distance")
        got = sim(theta, seed)
        assert abc_sim.launches("distance") == launches + 1
        assert torch.equal(got, ops.abc_sim_distance(
            theta, seed, obs, summary="weekly", distance="normalized_euclidean",
            **_small_kw()))


# ------------------------------------------------------- the other flat models
def _bits_equal(a, b):
    a = a.detach().cpu().numpy().astype(np.float32)
    b = np.asarray(b.detach().cpu() if hasattr(b, "detach") else b, np.float32)
    return a.shape == b.shape and bool((a.view(np.uint32) == b.view(np.uint32)).all())


def _entries_and_plain(cuda, model, observed, kw, batch, prior_seed, sim_seed, schedule=None):
    """Both entries of the model's kernel and the plain version on one input:
    the wave's theta against prior.sample, its distances and the theta-in
    entry's against the plain version, bitwise."""
    obs = torch.as_tensor(np.asarray(observed, np.float32), device=cuda)
    prior = schedule_prior(model, schedule)
    sim = ops.make_abc_sim(obs, model=model, schedule=schedule, **kw)
    name = f"abc_sim_wave_{model.name}"
    counts = (abc_sim.ENTRY_LAUNCHES.get(name, 0), ref.CALLS, priors.DEVICE_DRAWS)
    theta, dist = sim.wave(prior, prior_seed, sim_seed, batch)
    assert (abc_sim.ENTRY_LAUNCHES[name], ref.CALLS, priors.DEVICE_DRAWS) == (
        counts[0] + 1, counts[1], counts[2])
    want_theta = prior.sample(prior_seed, batch, cuda)
    assert theta.shape == (batch, prior.dim) and torch.equal(theta, want_theta)
    want = ref.abc_sim_distance_ref(want_theta, sim_seed, obs, model=model,
                                    schedule=schedule, **kw)
    d_in = sim(want_theta, sim_seed)
    assert _bits_equal(d_in, want)
    assert _bits_equal(dist, torch.where(torch.isnan(want), torch.full_like(want, float("inf")),
                                         want))


@pytest.mark.parametrize("name", ["sir", "seir", "seiard"])
def test_each_model_matches_plain_and_pins(cuda, name):
    """The theta-in entry equals `{model}/pallas` and the plain version bitwise
    on the pins; both entries equal the plain version at 1024 x 49."""
    model = get_model(name)
    pins = np.load(PINS)
    d_k, d_p = _kernel_and_plain(cuda, pins[f"{name}/theta"], 123, pins[f"{name}/observed"],
                                 model=model, **_small_kw())
    assert _bits_equal(torch.from_numpy(d_k), d_p)
    assert _bits_equal(torch.from_numpy(d_k), pins[f"{name}/pallas"])
    if name == "seiard":
        ds = data.get_dataset("italy", num_days=49, model=name)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    else:
        ds, kw = data.get_dataset("synthetic_small", num_days=49, model=name), _small_kw()
    _entries_and_plain(cuda, model, ds.observed, kw, 1024, 11, 77)


@pytest.mark.parametrize("name,tv", [("siard", "alpha"), ("sir", "beta"), ("seir", "beta"),
                                     ("seiard", "alpha0")])
@pytest.mark.parametrize("windows", ["one_fixed", "two_inferred"])
def test_each_model_under_a_schedule_matches_plain(cuda, name, tv, windows):
    """Both entries under the schedules of tests/test_interventions.py:142-170,
    bitwise the plain version at 1024 x 49."""
    model = get_model(name)
    schedule = (InterventionSchedule.fixed((tv,), (4,), (0.3,)) if windows == "one_fixed"
                else InterventionSchedule.inferred((tv,), (3, 8), 0.2, 1.5))
    obs = data.get_dataset("synthetic_small", num_days=49, model=name).observed
    _entries_and_plain(cuda, model, obs, _small_kw(), 1024, 12, 7, schedule)


def test_breakpoint_sweep_reuses_the_build(cuda):
    """Three lockdown days through one loaded library: no new build, each
    bitwise the plain version."""
    model = get_model("siard")
    obs = data.get_dataset("synthetic_small", num_days=49).observed
    ops.abc_sim_distance(paper_prior().sample(0, 32, cuda), 1,
                         torch.as_tensor(obs, device=cuda), **_small_kw())
    libs, infos = dict(build._LIBS), dict(build._INFO)
    for day in (10, 20, 30):
        _entries_and_plain(cuda, model, obs, _small_kw(), 1024, day, 5,
                           InterventionSchedule.fixed(("alpha0",), (day,), (0.3,)))
    assert build._LIBS == libs and build._INFO == infos


def test_each_model_kernel_is_in_its_library_sass(cuda):
    """kernel_symbol finds each model's 16 variants in its own library's
    cuobjdump listing, one function each."""
    from repro_torch.kernels import sass

    for name in ("siard", "sir", "seir", "seiard"):
        model = get_model(name)
        text = build.sass_text(abc_sim.library(model))
        if text is None:
            pytest.skip("the toolkit has no cuobjdump")
        funcs = sass.parse_functions(text)
        for v in range(16):
            flags = (v & 1, (v >> 1) & 1, 1 if v & 4 else 2, 0 if v & 4 else 1, 1)
            symbol = abc_sim.kernel_symbol(model, flags, bool(v & 8))
            assert sum(symbol in f for f in funcs) == 1, (name, symbol)


# ---------------------------------------------------------------- flash attention
#: (b, sq, h, kh, d, skv, causal, window, softcap): the cases of chip_smoke.py's
#: flash phase. The first three are tests/test_kernel_flash.py:21-25.
FLASH_CASES = [
    (1, 64, 2, 2, 16, 64, True, None, None),
    (2, 64, 4, 2, 16, 64, True, None, None),
    (1, 128, 4, 1, 32, 128, True, None, None),
    (1, 64, 2, 2, 16, 64, True, 16, 30.0),  # window and softcap
    (1, 24, 2, 2, 16, 40, False, None, None),  # non-causal, Skv != Sq
    (1, 2047, 8, 1, 256, 2047, True, None, None),  # ragged
    (1, 64, 2, 1, 32, 8, False, 16, None),  # rows 23.. have no allowed key
    (4, 2048, 8, 1, 256, 2048, True, None, None),  # gemma-2b prefill
    (1, 100, 4, 2, 72, 100, True, None, None),  # D a multiple of 8, not of 16
    (2, 50, 2, 1, 20, 50, True, None, None),  # D off the 8 grid: staged by element
    (1, 130, 4, 2, 128, 200, False, None, 30.0),  # Skv no multiple of 64, Sq != Skv
    (4, 2048, 16, 16, 128, 2048, True, None, None),  # deepseek-moe-16b prefill
    (4, 2048, 32, 4, 128, 2048, True, None, None),  # qwen3-moe-30b-a3b prefill (GQA 8)
    (4, 2048, 32, 32, 80, 2048, True, None, None),  # zamba2-2.7b shared attention (D 80)
    (4, 2048, 16, 8, 128, 2048, True, None, None),  # internvl2-2b prefill
    (4, 2048, 48, 8, 128, 2048, True, None, None),  # internlm2-20b prefill
    (4, 2048, 32, 8, 128, 2048, True, None, None),  # minitron-8b prefill
    (4, 1500, 20, 20, 64, 1500, False, None, None),  # whisper-large-v3 encoder (D 64)
    (4, 187, 20, 20, 64, 1500, False, None, None),  # whisper's cross-attention
    (4, 187, 20, 20, 64, 187, True, None, None),  # whisper's decoder self-attention
]
#: float32: the bar of tests/test_kernel_flash.py:31 (the float32 kernel's
#: 3xTF32 products keep about 21 bits of each factor). bf16: kernel and plain
#: version compute in float32 (the bf16 kernel keeps p to about 16 bits as
#: bf16 hi + lo) and round only the output, so they may differ by one bf16
#: step (at most 2^-7 |want|) over the float32 atol; the bars of
#: chip_smoke.py's flash phase.
FLASH_BARS = {torch.float32: dict(rtol=3e-4, atol=3e-5),
              torch.bfloat16: dict(rtol=2**-7, atol=3e-5)}


def _flash_qkv(b, sq, h, kh, d, skv, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
    return mk(b, sq, h, d), mk(b, skv, kh, d), mk(b, skv, kh, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, h, kh, d, skv, causal, window, softcap = case
    q, k, v = _flash_qkv(b, sq, h, kh, d, skv, dtype, cuda, seed=sq + h)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
              ref.FLASH_CALLS)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    bf = int(dtype == torch.bfloat16)
    after = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
             ref.FLASH_CALLS)
    assert after == (before[0] + 1, before[1] + bf, before[2] + 1 - bf, before[3])
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_BARS[dtype])
    if window is not None and not causal:
        dead = torch.arange(sq, device=cuda) - (skv - 1) >= window
        assert dead.any() and (got[:, dead] == 0).all()


def _route_launches(dtype):
    return fa.LAUNCHES_TENSOR_CORE if dtype == torch.bfloat16 else fa.LAUNCHES_TENSOR_CORE_F32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    (1, 70, 2, 1, 1, 70, True, None, None),  # D 1, padded to 64
    (1, 150, 2, 2, 100, 150, True, None, None),  # D 100 (by element in bf16), padded to 128
    (1, 90, 2, 1, 250, 120, False, 40, 50.0),  # D 250 by element, padded to 256
    (1, 300, 4, 1, 128, 300, True, 100, 50.0),  # window edge inside later tiles
], ids=lambda c: "-".join(map(str, c)))
def test_flash_bf16_kernel_on_every_padded_width(cuda, case, dtype):
    """Each tensor-core kernel's other instantiations (the bf16 one and, since
    the float32 route moved to the tensor cores, the 3xTF32 one): head dims
    staged element by element at each padded width, and a window that cuts
    tiles past the first, at its dtype's bar of the plain version."""
    b, sq, h, kh, d, skv, causal, window, softcap = case
    q, k, v = _flash_qkv(b, sq, h, kh, d, skv, dtype, cuda, seed=d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = _route_launches(dtype)
    got = fa.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _route_launches(dtype) == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_BARS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """A [B, H, S, D] tensor seen as [B, S, H, D] goes in without a copy, to
    the same bits, through each tensor-core kernel."""
    q, k, v = _flash_qkv(2, 96, 4, 2, 64, 96, dtype, cuda, seed=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qt.is_contiguous()
    before = _route_launches(dtype)
    got = fa.flash_attention_kernel(qt, kt, vt, causal=True, window=40, softcap=20.0)
    want = fa.flash_attention_kernel(q, k, v, causal=True, window=40, softcap=20.0)
    assert _route_launches(dtype) == before + 2
    assert torch.equal(got, want)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_qkv(1, 16, 2, 1, 32, 16, torch.float32, cuda)
    launches = fa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA|on"):
        fa.flash_attention_kernel(q, k.cpu(), v)
    with pytest.raises(ValueError, match="is on"):
        ops.flash_attention(q.cpu(), k, v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention_kernel(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention_kernel(q, k.bfloat16(), v)
    big = _flash_qkv(1, 16, 2, 1, 288, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim 288"):
        fa.flash_attention_kernel(*big)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_kernel(*_flash_qkv(1, 16, 3, 2, 32, 16, torch.float32, cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_kernel(q[..., ::2], k[..., ::2], v[..., ::2])
    assert fa.LAUNCHES == launches
    # rows that are not 16-byte pieces are no longer refused: they are staged
    # element by element (a sequence stride of 68 bf16 or 66 float32
    # elements, a base 2 or 4 bytes past an aligned one)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    wide = torch.zeros(1, 16, 68, dtype=torch.bfloat16, device=cuda)
    q68 = wide[..., :64].unflatten(-1, (2, 32))
    q68.copy_(qb)
    assert q68.stride()[:3] == (16 * 68, 68, 32)
    shifted = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(qb.shape)
    shifted.copy_(qb)
    wide = torch.zeros(1, 16, 66, dtype=torch.float32, device=cuda)
    q66 = wide[..., :64].unflatten(-1, (2, 32))
    q66.copy_(q)
    assert q66.stride()[:3] == (16 * 66, 66, 32)
    shifted32 = torch.zeros(q.numel() + 1, dtype=torch.float32, device=cuda)[1:].view(q.shape)
    shifted32.copy_(q)
    for qq, kk, vv in ((q68, kb, vb), (shifted, kb, vb), (q66, k, v), (shifted32, k, v)):
        staged = fa.LAUNCHES_STAGED
        got = fa.flash_attention_kernel(qq, kk, vv)
        assert fa.LAUNCHES_STAGED == staged + 1
        want = ref.flash_attention_ref(qq, kk, vv)
        torch.testing.assert_close(got.float(), want.float(), **FLASH_BARS[qq.dtype])
    assert fa.LAUNCHES == launches + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_stages_a_q_sliced_at_an_odd_offset(cuda, dtype):
    """q a view one element past an aligned base (chip_smoke.py's flash
    phase case): staged element by element by its route's kernel, within
    the dtype's bar of the plain version, and counted."""
    q, k, v = _flash_qkv(2, 96, 4, 2, 64, 96, dtype, cuda, seed=5)
    buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.data_ptr() % 16
    before = (_route_launches(dtype), fa.LAUNCHES_STAGED, ref.FLASH_CALLS)
    got = ops.flash_attention(q_odd, k, v, causal=True)
    assert (_route_launches(dtype), fa.LAUNCHES_STAGED, ref.FLASH_CALLS) == (
        before[0] + 1, before[1] + 1, before[2])
    want = ref.flash_attention_ref(q_odd, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_BARS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_entry_reads_16_byte_pieces_only_of_a_layout_made_of_them(cuda, dtype):
    """The wrapper decides how the rows are read and the C entry obeys: told
    to read a q at an odd offset in 16-byte pieces it refuses with
    cudaErrorInvalidValue (1) before any launch; told to stage it, it runs
    within the dtype's bar of the plain version."""
    q, k, v = _flash_qkv(2, 96, 4, 2, 64, 96, dtype, cuda, seed=5)
    q_odd = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)[1:].view(q.shape)
    q_odd.copy_(q)
    out = torch.zeros_like(q)
    strides = np.asarray([t.stride(i) for t in (q_odd, k, v, out) for i in range(3)], np.int64)
    assert fa.staged(dtype, 64, strides.tolist(), [t.data_ptr() for t in (q_odd, k, v, out)])
    fn, _, scratch_bytes = fa._fn(fa.route(dtype))
    scratch = [] if scratch_bytes is None else [
        torch.empty(scratch_bytes(2, 2, 96, 64), dtype=torch.uint8, device=cuda)]

    def call(staged):
        return fn(q_odd.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *[t.data_ptr() for t in scratch], 2, 4, 2, 96, 96, 64, strides.ctypes.data,
                  staged, 1, 0, 0.0, 0.125, torch.cuda.current_stream(cuda).cuda_stream)

    assert call(0) == 1
    torch.cuda.synchronize()
    assert not bool(out.any())
    assert call(1) == 0
    want = ref.flash_attention_ref(q_odd, k, v, causal=True)
    torch.testing.assert_close(out.float(), want.float(), **FLASH_BARS[dtype])


def test_gemma_2b_prefill_goes_through_the_kernel(cuda):
    """Full-width gemma-2b, 2 x 1024 prompt tokens: one launch a layer and no
    plain-version call; logits within 16 bf16 steps at the largest |logit|
    of the dense route (the bar of chip_smoke.py's lm_prefill phase)."""
    from repro_torch.models.registry import get_model

    model = get_model("gemma-2b")
    params = model.init_params(device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab, size=(2, 1024)), device=cuda)
    launches, calls = fa.LAUNCHES, ref.FLASH_CALLS
    tc = fa.LAUNCHES_TENSOR_CORE
    got = model.with_cfg(attn_impl="flash").prefill(params, {"tokens": tokens})
    assert (fa.LAUNCHES - launches, ref.FLASH_CALLS - calls) == (model.cfg.n_layers, 0)
    assert fa.LAUNCHES_TENSOR_CORE - tc == model.cfg.n_layers
    want = model.with_cfg(attn_impl="dense").prefill(params, {"tokens": tokens})
    assert got.shape == (2, 1, model.cfg.vocab) and bool(torch.isfinite(got).all())
    top = float(want.abs().max())
    bar = 16 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float((got - want).abs().max()) <= bar


def test_moe_smoke_prefill_on_the_card_matches_its_cpu_run(cuda):
    """deepseek-moe-16b smoke (a dense prefix layer, shared experts) through
    the bf16 flash kernel on the card, one launch a layer, against the same
    parameters' plain run on the CPU: logits within 16 bf16 steps at the
    largest |logit| (chip_smoke.py's prefill bar), argmax equal where the
    top two are more than twice that apart."""
    from repro_torch.models.registry import get_model

    model = get_model("deepseek-moe-16b", smoke=True).with_cfg(attn_impl="flash")
    params = model.init_params(device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab, size=(2, 64)))
    want = model.prefill(params, {"tokens": tokens})
    on_card = [{k: v.to(cuda) if not isinstance(v, dict) else
                {kk: vv.to(cuda) for kk, vv in v.items()} for k, v in layer.items()}
               for layer in params["layers"]]
    card_params = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    card_params["layers"] = on_card
    launches, calls, tc = fa.LAUNCHES, ref.FLASH_CALLS, fa.LAUNCHES_TENSOR_CORE
    got = model.prefill(card_params, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - launches, ref.FLASH_CALLS - calls) == (model.cfg.n_layers, 0)
    assert fa.LAUNCHES_TENSOR_CORE - tc == model.cfg.n_layers
    got = got.cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    bar = 16 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got - want).abs().max()) <= bar
    top2 = torch.topk(want[:, 0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
    assert bool((got[:, 0].argmax(-1) == want[:, 0].argmax(-1))[decided].all())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internvl2-2b", "minitron-8b"])
def test_family_prefill_goes_through_the_kernel(cuda, arch):
    """Full-width zamba2-2.7b (shared attention, D 80 padded in the kernel),
    internvl2-2b (256 patch rows, then text) and minitron-8b on 2 x 512 rows:
    one launch a shared-block site or a layer, no plain call, logits within
    16 bf16 steps at the largest |logit| of the dense route, argmax equal
    where the top two are more than twice that apart (chip_smoke.py's
    family_prefill bar)."""
    from repro_torch.models.registry import get_model

    model = get_model(arch)
    cfg = model.cfg
    lm = cfg.lm if model.family == "vlm" else cfg
    params = model.init_params(device=cuda)
    rng = np.random.default_rng(0)
    if model.family == "vlm":
        batch = {"patch_embeds": torch.randn((2, cfg.n_patches, cfg.vit_dim), device=cuda,
                                             generator=torch.Generator(device=cuda).manual_seed(0)
                                             ).to(torch.bfloat16),
                 "tokens": torch.as_tensor(rng.integers(0, lm.vocab, size=(2, 512 - cfg.n_patches)),
                                           device=cuda)}
    else:
        batch = {"tokens": torch.as_tensor(rng.integers(0, lm.vocab, size=(2, 512)), device=cuda)}
    sites = cfg.n_super if model.family == "hybrid" else lm.n_layers
    launches, calls, tc = fa.LAUNCHES, ref.FLASH_CALLS, fa.LAUNCHES_TENSOR_CORE
    got = model.with_cfg(attn_impl="flash").prefill(params, batch)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - launches, ref.FLASH_CALLS - calls) == (sites, 0)
    assert fa.LAUNCHES_TENSOR_CORE - tc == sites
    want = model.with_cfg(attn_impl="dense").prefill(params, batch)
    assert got.shape == (2, 1, lm.vocab) and bool(torch.isfinite(got).all())
    bar = 16 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got - want).abs().max()) <= bar
    top2 = torch.topk(want[:, 0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
    assert bool((got[:, 0].argmax(-1) == want[:, 0].argmax(-1))[decided].all())


def test_mamba2_prefill_on_the_card_matches_its_decode_and_the_cpu(cuda):
    """Full-width mamba2-130m launches no flash kernel; on the card its
    chunked prefill of 2 x 64 tokens equals its token-by-token decode within
    chip_smoke.py's bf16 bar (32 steps at the largest |logit|), and the CPU's
    run of the same parameters within 16 steps."""
    from repro_torch.models.registry import get_model

    model = get_model("mamba2-130m")
    params = model.init_params(device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab, size=(2, 64)))
    want = model.prefill(params, {"tokens": tokens})
    card = {"embed": params["embed"].to(cuda), "final_norm": params["final_norm"].to(cuda),
            "layers": [{k: v.to(cuda) for k, v in lp.items()} for lp in params["layers"]]}
    toks = tokens.to(cuda)
    launches = fa.LAUNCHES
    got = model.prefill(card, {"tokens": toks})
    assert fa.LAUNCHES == launches
    step = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got.cpu() - want).abs().max()) <= 16 * step
    cache = model.init_cache(2, 0, cuda)
    for i in range(toks.shape[1]):
        dec, cache = model.decode_step(card, cache, {"tokens": toks[:, i:i + 1], "pos": i})
    assert float((dec - got).abs().max()) <= 32 * step


@pytest.mark.parametrize("shape", [(16, 4, 64, 32, 2), (64, 6, 256, 64, 2), (128, 8, 256, 48, 0)],
                         ids=lambda s: "e{}-k{}-d{}-f{}-shared{}".format(*s))
def test_moe_layer_on_the_card_matches_the_dense_oracle(cuda, shape):
    """The capacity dispatch on the card at ample capacity against every
    expert on every token (tests/test_moe.py's oracle and bar), and against
    its own CPU run at that bar."""
    import dataclasses

    from repro_torch.models import moe

    e, k, d, f, n_shared = shape
    cfg = moe.MoEConfig(n_experts=e, top_k=k, d_expert=f, n_shared=n_shared,
                        capacity_factor=e / k)
    params = moe.init_moe(torch.Generator().manual_seed(0), d, cfg)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 64, d), dtype=np.float32)
                        ).to(torch.bfloat16)
    card = {name: t.to(cuda) for name, t in params.items()}
    y, aux = moe.moe_ffn(x.to(cuda), card, cfg)
    want = moe.dense_reference(x.to(cuda), card, cfg)
    bar = dict(rtol=0.08, atol=0.05)
    torch.testing.assert_close(y.float(), want.float(), **bar)
    torch.testing.assert_close(y.float().cpu(), moe.moe_ffn(x, params, cfg)[0].float(), **bar)
    assert float(aux) > 0
    tight = dataclasses.replace(cfg, capacity_factor=0.25)
    r = moe.route(x.to(cuda).reshape(-1, d), card["router"], tight, moe.capacity(128, tight))
    assert 0 < int((~r.keep).sum()) < r.keep.numel()


# ------------------------------------------------- encoder-decoder and training
def test_whisper_prefill_goes_through_the_kernel(cuda):
    """Full-width whisper-large-v3 on 1 x 1,500 frames and 187 tokens: 96
    bf16 launches (32 encoder, 32 causal decoder, 32 cross-attention with
    Skv 1,500 != Sq 187), no plain call, logits within 16 bf16 steps of the
    dense route at the largest |logit| (chip_smoke.py's encdec_prefill bar),
    argmax equal where the top two are more than twice that apart."""
    from repro_torch.models.registry import get_model

    model = get_model("whisper-large-v3")
    params = model.init_params(device=cuda)
    batch = model.example_inputs("prefill", 1, 1500, cuda)
    assert batch["tokens"].shape == (1, 187)
    launches, calls, tc = fa.LAUNCHES, ref.FLASH_CALLS, fa.LAUNCHES_TENSOR_CORE
    got = model.with_cfg(attn_impl="flash").prefill(params, batch)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - launches, ref.FLASH_CALLS - calls) == (96, 0)
    assert fa.LAUNCHES_TENSOR_CORE - tc == 96
    want = model.with_cfg(attn_impl="dense").prefill(params, batch)
    assert got.shape == (1, 1, model.cfg.vocab) and bool(torch.isfinite(got).all())
    bar = 16 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got - want).abs().max()) <= bar
    top2 = torch.topk(want[:, 0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
    assert bool((got[:, 0].argmax(-1) == want[:, 0].argmax(-1))[decided].all())


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b", "mamba2-130m", "zamba2-2.7b",
                                  "whisper-large-v3", "internvl2-2b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One build_train_step step of each family's smoke model on the card
    against the same step on the CPU from the same parameters: loss rtol
    1e-3, grad norm rtol 1e-2 (tests/test_torch_train_families.py's bars),
    each parameter within 2 lr + one bf16 step (a first AdamW step moves a
    parameter by lr (g / |g| + wd p))."""
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    model = get_model(arch, smoke=True)
    lr = 1e-3
    fn = steps.build_train_step(model, InputShape("t", "train", 64, 2),
                                opt_cfg=AdamWConfig(lr=lr, warmup_steps=1)).fn
    batch = model.example_inputs("train", 2, 64, "cpu", seed=1)
    pc = model.init_params(device="cpu")
    pg = _on(pc, cuda)
    pc, _, mc = fn(pc, adamw_init(pc), batch)
    pg, _, mg = fn(pg, adamw_init(pg), _on(batch, cuda))
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-3 * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 1e-2 * float(mc["grad_norm"])
    for c, g in zip(tree_leaves(pc), tree_leaves(pg)):
        c, g = c.float(), g.float().cpu()
        assert bool(((g - c).abs() <= 2 * lr + 2.0 ** -7 * c.abs()).all())


def test_a_loss_through_flash_is_refused_on_the_card(cuda):
    """Neither flash kernel has a backward: a gradient through the flash
    route raises on the card as on the CPU, and launches nothing."""
    from repro_torch.kernels.ops import FlashBackwardError
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.registry import get_model

    model = get_model("gemma-2b", smoke=True)
    params = model.init_params(device=cuda)
    batch = model.example_inputs("train", 2, 64, cuda)
    launches = fa.LAUNCHES
    with pytest.raises(FlashBackwardError, match="no backward"):
        value_and_grad(model.with_cfg(attn_impl="flash"), params, batch)
    assert fa.LAUNCHES == launches
    assert model.with_cfg(attn_impl="flash").prefill(params, batch).shape == (2, 1, model.vocab)
    assert fa.LAUNCHES == launches + model.cfg.n_layers


# ------------------------------------------------------------ the region axis
METAPOP_PAIRS = [("identity", "euclidean"), ("region_pooled", "euclidean"),
                 ("log_weekly", "mae")]


def _regional(name, regions=None, mobility=None):
    from repro_torch.epi.spec import regionalize

    spec = get_model(name)
    return spec if regions is None else regionalize(spec, regions, mobility)


#: (model, R, mobility): R = 33, 64 and 128 give a warp route's lanes up to
#: 2, 2 and 4 regions; seiard at R=40 has 120 channels and no coupling
REGIONAL_CASES = [("metapop_seir", None, None), ("metapop_seir", 10, "ring:0.1"),
                  ("metapop_seir", 33, "ring:0.1"), ("metapop_seir", 64, "ring:0.1"),
                  ("metapop_seir", 100, "ring:0.1"), ("metapop_seir", 128, "ring:0.1"),
                  ("seir", 3, None), ("siard", 3, None), ("seiard", 2, "uniform:0.2"),
                  ("seiard", 40, None)]


def _regional_sim(cuda, spec, summary=None, distance="euclidean", **extra):
    ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0, model=spec,
              summary=summary, distance=distance, **extra)
    obs = torch.as_tensor(ds.observed, device=cuda)
    return obs, kw, ops.make_abc_sim(obs, **kw)


def _launch(sim, entry, batch, route=None, block=None):
    """`sim`'s launch of `entry` at `batch` on `route`, at `block` threads
    where one is given (`abc_sim.launch` of the simulator's buffers)."""
    if block is None:
        return sim.launch(entry, batch, route)
    return abc_sim.launch(sim.model, entry, batch, obs=sim.obs_summary, fconst=sim.fconst,
                          iconst=sim.iconst, weights=sim.weights, mobility=sim.mob,
                          tile=sim.tile, pool=sim.pool, block=block, route=route)


def _route_entries(sim, spec, theta, prior, seed, prior_seed, route, block=None):
    """(theta-in distances, wave theta, wave distances) of one route."""
    batch = theta.shape[0]
    d = _launch(sim, "distance", batch, route, block)(seed, abc_sim.theta_to_soa(theta))
    th_w, d_w = _launch(sim, "wave", batch, route, block)(seed, prior_seed, prior.lows,
                                                          prior.highs)
    return d, th_w, d_w


@pytest.mark.parametrize("case", REGIONAL_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("summary,distance", METAPOP_PAIRS)
def test_regional_entries_equal_the_plain_version(cuda, case, summary, distance):
    """Both regional entries of both routes against the plain version,
    bitwise (theta and distances): through `ops` on the route R picks, one
    launch of its entry each, and through each route's entries."""
    spec = _regional(*case)
    obs, kw, sim = _regional_sim(cuda, spec, summary, distance)
    prior = spec.prior()
    theta = prior.sample(8, 1024, cuda)
    want = ref.abc_sim_distance_ref(theta, 3, obs, **kw)
    want_wave = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
    entry = abc_sim.entry_name(spec, "distance")
    before = abc_sim.ENTRY_LAUNCHES.get(entry, 0)
    assert torch.equal(ops.abc_sim_distance(theta, 3, obs, **kw), want)
    assert abc_sim.ENTRY_LAUNCHES[entry] == before + 1
    got_theta, got = sim.wave(prior, 8, 3, 1024)
    assert torch.equal(got_theta, theta)
    assert torch.equal(got, want_wave)
    for route in abc_sim.ROUTES:
        before = dict(abc_sim.ENTRY_LAUNCHES)
        d, th_w, d_w = _route_entries(sim, spec, theta, prior, 3, 8, route)
        assert torch.equal(d, want) and torch.equal(th_w, theta) and torch.equal(d_w, want_wave)
        for e in ("distance", "wave"):
            name = abc_sim.entry_name(spec, e, route)
            assert abc_sim.ENTRY_LAUNCHES[name] == before.get(name, 0) + 1


@pytest.mark.parametrize("regions", [None, 100], ids=["metapop_path-4", "regions_path-100"])
def test_both_routes_equal_the_plain_version_at_the_paths_batch(cuda, regions):
    """Both entries of both routes at the CLI paths' shape, 100,000 x 49 on
    metapop_seir (R=4, and R=100 on a ring at 0.1), bitwise the plain
    version."""
    spec = _regional("metapop_seir", regions, None if regions is None else "ring:0.1")
    obs, kw, sim = _regional_sim(cuda, spec)
    prior = spec.prior()
    theta = prior.sample(6, 100_000, cuda)
    want = ref.abc_sim_distance_ref(theta, 9, obs, **kw)
    want_wave = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
    for route in abc_sim.ROUTES:
        d, th_w, d_w = _route_entries(sim, spec, theta, prior, 9, 6, route)
        assert torch.equal(d, want) and torch.equal(th_w, theta) and torch.equal(d_w, want_wave)


def test_regional_route_follows_the_batch_on_the_card(cuda):
    """metapop_seir at R=16 through `AbcSim.wave`: the warp entry at 20,000
    samples, the thread entry at 50,000 (`WARP_MIN_REGIONS`), each bitwise
    the other route at the same batch."""
    spec = _regional("metapop_seir", 16, "ring:0.1")
    _, _, sim = _regional_sim(cuda, spec)
    prior = spec.prior()
    for batch, route in ((20_000, "warp"), (50_000, "thread")):
        assert abc_sim.regional_route(spec, batch) == route
        other = "thread" if route == "warp" else "warp"
        before = dict(abc_sim.ENTRY_LAUNCHES)
        theta, dist = sim.wave(prior, 4, 7, batch)
        name = abc_sim.entry_name(spec, "wave", route)
        assert abc_sim.ENTRY_LAUNCHES[name] == before.get(name, 0) + 1
        assert abc_sim.ENTRY_LAUNCHES == {**before, name: before.get(name, 0) + 1}
        th_o, d_o = sim.launch("wave", batch, other)(7, 4, prior.lows, prior.highs)
        assert torch.equal(th_o, theta) and torch.equal(d_o, dist)


@pytest.mark.parametrize("case", [("metapop_seir", 100, "ring:0.1"), ("seiard", 40, None)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_regional_warp_kernel_is_block_invariant(cuda, case):
    """The warp route's distances and theta do not depend on the samples a
    block (block / 32), including a ragged last block."""
    spec = _regional(*case)
    _, _, sim = _regional_sim(cuda, spec)
    prior = spec.prior()
    theta = prior.sample(5, 1000, cuda)
    first = _route_entries(sim, spec, theta, prior, 4, 5, "warp", 32)
    for block in (128, 256, 384, 512):
        got = _route_entries(sim, spec, theta, prior, 4, 5, "warp", block)
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("regions", [None, 40], ids=["thread-4", "warp-40"])
def test_regional_schedule_and_mobility_sweep_reuse_one_build(cuda, regions):
    """A one-window schedule on metapop_seir, and three mobility matrices
    through the loaded library: bitwise the plain version, no rebuild, on
    the route R picks (thread at R=4, warp at R=40)."""
    from repro_torch.epi.spec import make_mobility

    spec = _regional("metapop_seir", regions, None if regions is None else "ring:0.1")
    R = spec.n_regions
    ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0, model=spec)
    obs = torch.as_tensor(ds.observed, device=cuda)
    sched = InterventionSchedule.inferred(("beta",), (20,), 0.0, 2.0)
    theta = schedule_prior(spec, sched).sample(2, 2048, cuda)
    entry = abc_sim.entry_name(spec, "distance")
    assert entry.endswith(("_warp_metapop_seir" if regions else "distance_metapop_seir"))
    before = abc_sim.ENTRY_LAUNCHES.get(entry, 0)
    assert torch.equal(ops.abc_sim_distance(theta, 4, obs, schedule=sched, **kw),
                       ref.abc_sim_distance_ref(theta, 4, obs, schedule=sched, **kw))
    libs, built = dict(build._LIBS), dict(build._INFO)
    theta = spec.prior().sample(3, 2048, cuda)
    seen = []
    for grammar in ("identity", "ring:0.1", "uniform:0.2"):
        mob = make_mobility(grammar, R)
        got = ops.abc_sim_distance(theta, 4, obs, mobility=mob, **kw)
        assert torch.equal(got, ref.abc_sim_distance_ref(theta, 4, obs, mobility=mob, **kw))
        assert not any(torch.equal(got, s) for s in seen)
        seen.append(got)
    assert (build._LIBS, build._INFO) == (libs, built)
    assert abc_sim.ENTRY_LAUNCHES[entry] == before + 4


def test_regional_kernel_refuses_past_max_regions(cuda, monkeypatch):
    """R past MAX_REGIONS on the thread or warp route: the wrapper raises a
    ValueError naming the limit; past the wrapper, the C entry refuses to
    launch. (The simulator takes such an R on the tile route,
    `tests/test_torch_regional_tile.py`.)"""
    spec = _regional("metapop_seir", abc_sim.MAX_REGIONS + 1, "ring:0.1")
    obs = torch.zeros((spec.total_observed, 5), device=cuda)
    assert ops.make_abc_sim(obs, model=spec, population=1e6, a0=10.0).entry(
        "wave", 64) == "abc_sim_regional_wave_tile_metapop_seir"
    for route in ("thread", "warp"):
        with pytest.raises(ValueError, match=f"MAX_REGIONS = {abc_sim.MAX_REGIONS}"):
            abc_sim.check_regional(spec, obs, torch.zeros((129, 129), device=cuda),
                                   torch.zeros((spec.total_observed,), device=cuda), 1, route)
    monkeypatch.setattr(abc_sim, "check_regional", lambda *a: None)
    fconst, iconst = abc_sim.pack_consts(population=1e6, a0=10.0, r0=0.0, d0=0.0,
                                         mean_scale=1.0, weights=[], flags=(0, 0, 2, 1, 1),
                                         seed=1)
    mob = torch.full((spec.n_regions, spec.n_regions), 1.0 / spec.n_regions, device=cuda)
    weights = torch.ones((spec.total_observed,), device=cuda)
    theta = abc_sim.theta_to_soa(spec.prior().sample(1, 64, cuda))
    before = dict(abc_sim.ENTRY_LAUNCHES)
    for route in ("thread", "warp"):
        with pytest.raises(RuntimeError, match="launch failed"):
            abc_sim.launch(spec, "distance", 64, obs=obs, fconst=fconst, iconst=iconst,
                           weights=weights, mobility=mob, route=route)(1, theta)
    assert abc_sim.ENTRY_LAUNCHES == before


def test_a_simulator_keeps_one_launch_a_batch(cuda, monkeypatch):
    """Two waves of one simulator at one batch go through one `Launch`,
    made once by `abc_sim.launch`, bitwise the same; a second batch gets
    its own. Its name is the entry `AbcSim.entry` names."""
    spec = get_model("siard")
    ds = data.get_dataset("italy", num_days=20)
    sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=cuda), model=spec,
                           population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    made, real = [], abc_sim.launch
    monkeypatch.setattr(abc_sim, "launch", lambda *a, **k: made.append(a[1:3]) or real(*a, **k))
    prior = spec.prior()
    first = sim.wave(prior, 1, 2, 1024)
    ln = sim.launch("wave", 1024)
    second = sim.wave(prior, 1, 2, 1024)
    assert sim.launch("wave", 1024) is ln and made == [("wave", 1024)]
    assert all(_bits_equal(a, b) for a, b in zip(first, second))
    sim.wave(prior, 1, 2, 2048)
    assert sim.launch("wave", 2048) is not ln
    assert made == [("wave", 1024), ("wave", 2048)]
    assert (ln.name, ln.route, ln.block) == (sim.entry("wave", 1024), "flat", 256)


def test_run_abc_on_the_card_goes_through_the_regional_kernel(cuda):
    """metapop_seir through run_abc: 1 + waves launches of the regional wave
    entry, no host prior draw, no plain-version call, the posterior in the
    box."""
    spec = get_model("metapop_seir")
    ds = data.get_dataset("synthetic_small", num_days=30, model=spec)
    cfg = tabc.ABCConfig(batch_size=16384, chunk_size=2048, num_days=30, tolerance=1.0,
                         target_accepted=40, max_runs=30, model=spec)
    abc_sim.ENTRY_LAUNCHES.clear()
    abc_sim.ENTRY_GATED.clear()
    draws, calls = priors.DEVICE_DRAWS, ref.CALLS
    eps = tabc.calibrate_tolerance(ds, cfg, seed=2, quantile=0.01, n_pilot=16384, device=cuda)
    post = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps), seed=2, device=cuda)
    gated = abc_sim.ENTRY_GATED.get("abc_sim_regional_wave_metapop_seir", 0)
    assert abc_sim.ENTRY_LAUNCHES == {"abc_sim_regional_wave_metapop_seir": 1 + post.runs + gated}
    assert gated < tabc.SEGMENT_WAVES
    assert (priors.DEVICE_DRAWS, ref.CALLS) == (draws, calls)
    lo, hi = np.asarray(spec.prior().lows), np.asarray(spec.prior().highs)
    assert len(post) >= 40 and ((post.theta >= lo) & (post.theta <= hi)).all()


def test_run_abc_at_100_regions_goes_through_the_warp_kernel(cuda):
    """metapop_seir at R=100 through run_abc: 1 + waves launches of the warp
    route's wave entry and none of the thread route's, no host prior draw,
    no plain-version call."""
    from repro_torch.epi.spec import regionalize

    spec = regionalize(get_model("metapop_seir"), 100, "ring:0.1")
    assert abc_sim.regional_route(spec) == "warp"
    ds = data.get_dataset("synthetic_small", num_days=20, model=spec)
    cfg = tabc.ABCConfig(batch_size=8192, chunk_size=2048, num_days=20, tolerance=1.0,
                         target_accepted=20, max_runs=20, model=spec)
    abc_sim.ENTRY_LAUNCHES.clear()
    abc_sim.ENTRY_GATED.clear()
    draws, calls = priors.DEVICE_DRAWS, ref.CALLS
    eps = tabc.calibrate_tolerance(ds, cfg, seed=2, quantile=0.01, n_pilot=8192, device=cuda)
    post = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps), seed=2, device=cuda)
    gated = abc_sim.ENTRY_GATED.get("abc_sim_regional_wave_warp_metapop_seir", 0)
    assert abc_sim.ENTRY_LAUNCHES == {
        "abc_sim_regional_wave_warp_metapop_seir": 1 + post.runs + gated}
    assert gated < tabc.SEGMENT_WAVES
    assert (priors.DEVICE_DRAWS, ref.CALLS) == (draws, calls)
    lo, hi = np.asarray(spec.prior().lows), np.asarray(spec.prior().highs)
    assert len(post) >= 20 and ((post.theta >= lo) & (post.theta <= hi)).all()


# ------------------------------------------------------ the device wave loop
LOOP_CASES = [("siard", None), ("sir", None), ("seir", None), ("seiard", None),
              ("metapop_seir", None), ("metapop_seir", 100)]


@pytest.mark.parametrize("case", LOOP_CASES, ids=lambda c: f"{c[0]}-{c[1] or 'as registered'}")
def test_device_loop_equals_the_host_loop_on_the_card(cuda, case):
    """Bitwise the host loop's accepted set, runs and simulations, for each
    flat model and for metapop_seir at R=4 (thread route) and R=100 (warp
    route); the device loop calls neither `_harvest` nor the plain version."""
    from repro_torch.epi.spec import regionalize

    name, regions = case
    spec = regionalize(get_model(name), regions, "ring:0.1") if regions else get_model(name)
    ds = data.get_dataset("italy" if name in ("siard", "seiard") else "synthetic_small",
                          num_days=30, model=spec)
    cfg = tabc.ABCConfig(batch_size=16384, chunk_size=2048, num_days=30, tolerance=1.0,
                         target_accepted=40, max_runs=30, model=spec)
    eps = tabc.calibrate_tolerance(ds, cfg, seed=3, quantile=0.005, n_pilot=16384, device=cuda)
    host = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps, wave_loop="host"), seed=3,
                        device=cuda)
    harvest, calls = tabc._harvest, ref.CALLS
    tabc._harvest = None  # the device loop must not reach it
    try:
        dev = tabc.run_abc(ds, dataclasses.replace(cfg, tolerance=eps, wave_loop="device"),
                           seed=3, device=cuda)
    finally:
        tabc._harvest = harvest
    assert ref.CALLS == calls
    assert (dev.runs, dev.simulations, len(dev)) == (host.runs, host.simulations, len(host))
    assert len(host) >= 40
    assert _bits_equal(torch.from_numpy(dev.theta), host.theta)
    assert _bits_equal(torch.from_numpy(dev.distances), host.distances)


def test_a_device_loop_segment_makes_no_host_sync(cuda):
    """One segment of the device loop enqueues its waves under
    set_sync_debug_mode("error"), and its accepted set is run_abc's."""
    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(batch_size=32768, chunk_size=4096, num_days=49, tolerance=1.0,
                         target_accepted=30, max_runs=16)
    eps = tabc.calibrate_tolerance(ds, cfg, seed=0, quantile=1e-3, n_pilot=32768, device=cuda)
    cfg = dataclasses.replace(cfg, tolerance=eps)
    runner = tabc.make_wave_runner(get_model("siard").prior(),
                                   tabc.make_simulator(ds, cfg, cuda), cfg)
    carry = runner.init(tabc.ABCState(n_params=8))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = runner(0, 0, carry, tabc.SEGMENT_WAVES)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    waves, n, fill = runner.read(out)
    state = tabc.ABCState(n_params=8)
    runner.harvest(out, state, fill)
    post = tabc.run_abc(ds, dataclasses.replace(cfg, max_runs=waves), seed=0, device=cuda)
    assert (post.runs, len(post)) == (waves, fill)
    theta, dist = state.to_arrays()
    assert _bits_equal(torch.from_numpy(theta), post.theta)
    assert _bits_equal(torch.from_numpy(dist), post.distances)


def _gate_entries(cuda, spec, route, batch=2048):
    ds = data.get_dataset("italy" if spec.name in ("siard", "seiard") else "synthetic_small",
                          num_days=30, model=spec)
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=cuda), model=spec, **kw)
    box = spec.prior()
    soa = abc_sim.theta_to_soa(box.sample(3, batch, cuda))
    wave, theta_in = (sim.launch(e, batch, route) for e in ("wave", "distance"))
    return box, {
        "wave": lambda gate=None, out=None: wave(5, 9, box.lows, box.highs, gate=gate, out=out),
        "distance": lambda gate=None, out=None: (theta_in(5, soa, gate=gate, out=out),)}


GATE_CASES = [(m, None, None) for m in ("siard", "sir", "seir", "seiard")] + [
    ("metapop_seir", r, route) for r in (None, 100) for route in ("thread", "warp")]


@pytest.mark.parametrize("case", GATE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_a_gate_of_zero_writes_nothing(cuda, case):
    """Each entry launched under a gate of 0 leaves its sentinel-filled
    buffers bitwise unchanged; under a gate of 1 it equals the ungated
    launch; a gate off the device is refused."""
    from repro_torch.epi.spec import regionalize

    name, regions, route = case
    spec = regionalize(get_model(name), regions, "ring:0.1") if regions else get_model(name)
    box, entries = _gate_entries(cuda, spec, route)
    batch = 2048
    zero = torch.zeros((1,), dtype=torch.int32, device=cuda)
    one = torch.ones((1,), dtype=torch.int32, device=cuda)
    for entry, fn in entries.items():
        def fresh():
            t = torch.full((batch, box.dim), 7.5, device=cuda)
            d = torch.full((batch,), -3.25, device=cuda)
            return (t, d) if entry == "wave" else d

        before = dict(abc_sim.ENTRY_LAUNCHES)
        buffers = fresh()
        fn(zero, buffers)
        torch.cuda.synchronize()
        assert sum(abc_sim.ENTRY_LAUNCHES.values()) == sum(before.values()) + 1
        for got, want in zip(buffers if entry == "wave" else (buffers,),
                             fresh() if entry == "wave" else (fresh(),)):
            assert _bits_equal(got, want), (entry, "gate 0 wrote")
        for got, want in zip(fn(one, fresh()), fn()):
            assert _bits_equal(got, want), (entry, "gate 1")
        with pytest.raises(ValueError, match="gate must be an int32 tensor"):
            fn(torch.ones((1,), dtype=torch.int32))
        with pytest.raises(ValueError, match="gate must be an int32 tensor"):
            fn(torch.ones((1,), dtype=torch.int64, device=cuda))


def test_the_census_of_a_sample_day_holds(cuda):
    """The gate adds instructions outside the day loop only: the census of
    a sample-day stays at PERF.md's counts, but for the warp route, whose
    day loop ptxas schedules 5 warp-instructions shorter (2,938 before the
    gate; experiments/abc_sim_gate_census.py)."""
    from repro_torch.core.summaries import get_summary, lower_summary
    from repro_torch.kernels import sass

    flags = lower_summary(get_summary(None), "euclidean", torch.ones(3, 49)).flags
    want = {"siard": 660, "sir": 249, "seir": 353, "seiard": 762}
    for name, total in want.items():
        text = build.sass_text(abc_sim.library(name))
        if text is None:
            pytest.skip("the toolkit has no cuobjdump")
        funcs = sass.parse_functions(text)
        symbol = abc_sim.kernel_symbol(get_model(name), flags, True)
        body = next(f for k, f in funcs.items() if symbol in k)
        assert sass.census(body)["per_day"]["total"] == total, name
    metapop = get_model("metapop_seir")
    funcs = sass.parse_functions(build.sass_text(abc_sim.library(metapop)))
    thread = next(f for k, f in funcs.items()
                  if abc_sim.kernel_symbol(metapop, flags, True, "thread") in k)
    warp = next(f for k, f in funcs.items()
                if abc_sim.kernel_symbol(metapop, flags, True, "warp") in k)
    assert sass.regional_per_day(sass.regional_census(thread, True), 4, 4)["total"] == 1671
    assert sass.regional_warp_per_day(sass.regional_warp_census(warp, True), 100,
                                      200)["total"] == 2933


def test_the_smc_device_round_accepts_at_or_below_eps_on_the_card(cuda):
    """make_smc_round_fn on the card: its rows lie in the box at or below eps,
    through the theta-in entry (waves + gated launches) and no plain call;
    SMC through run_smc_abc falls in eps every round."""
    from repro_torch.core import smc as tsmc

    ds = data.get_dataset("italy", num_days=30)
    cfg = tsmc.SMCConfig(n_particles=200, batch_size=16384, n_rounds=3, num_days=30,
                         wave_loop="device")
    prior = get_model("siard").prior()
    sim = tabc.make_simulator(ds, tabc.ABCConfig(batch_size=16384, chunk_size=16384,
                                                 num_days=30, tolerance=np.inf), cuda)
    particles = prior.sample(1, 200).numpy()
    d0 = sim(torch.from_numpy(particles).to(cuda), 1).cpu().numpy()
    eps = float(np.quantile(d0[np.isfinite(d0)], 0.5))
    sigma = np.full(8, 0.02, np.float32)
    abc_sim.ENTRY_LAUNCHES.clear()
    abc_sim.ENTRY_GATED.clear()
    calls = ref.CALLS
    th, d, accepted, waves = tsmc.make_smc_round_fn(sim, prior, cfg)(
        4, 1, particles, np.full(200, 1 / 200), sigma, eps, 8)
    assert ref.CALLS == calls and th.shape[0] == min(accepted, 200) > 0
    assert abc_sim.ENTRY_LAUNCHES == {
        "abc_sim_distance_siard": waves + abc_sim.ENTRY_GATED.get("abc_sim_distance_siard", 0)}
    assert (d <= np.float32(eps)).all()
    lo, hi = np.asarray(prior.lows, np.float32), np.asarray(prior.highs, np.float32)
    assert ((th >= lo) & (th <= hi)).all()
    post = tsmc.run_smc_abc(ds, cfg, seed=2, device=cuda)
    assert all(a > b for a, b in zip(post.round_eps, post.round_eps[1:]))
    assert len(post) == 200 and np.isfinite(post.theta).all()


def _forecast_server(cuda, slots=3):
    """An EpiServer on the card holding prior samples as Italy's SIARD
    posterior (forecasting is fit-agnostic: no fit runs)."""
    from repro_torch.core.posterior import Posterior
    from repro_torch.core.serving import EpiServer, ServeConfig
    from repro_torch.core.smc import SMCConfig

    server = EpiServer(ServeConfig(slots=slots, forecast_particles=64,
                                   fit=SMCConfig(num_days=21, wave_loop="device")), cuda)
    spec = get_model("siard")
    theta = spec.prior().sample(5, 200, "cpu").numpy()
    post = Posterior(theta=theta, distances=np.arange(200, dtype=np.float32), tolerance=1.0,
                     param_names=spec.param_names)
    server.preload("italy", "siard", post)
    return server, post


def test_batched_forecasts_equal_sequential_ones_on_the_card(cuda):
    """8 queries over 2 shapes at 3 slots (a padded final chunk each): every
    response dict-equal to sequential forecast_bands on the card, no fit, 4
    batched calls over 2 entries; each lane of a batched trajectory bitwise
    simulate_observed for that lane alone."""
    from repro_torch.core.serving import ForecastQuery, forecast_seed
    from repro_torch.epi import engine
    from repro_torch.epi.spec import EpiModelConfig
    from repro_torch.launch.abc_run import parse_intervention, posterior_forecast

    server, post = _forecast_server(cuda)
    sched = parse_intervention("alpha@10=0.5")
    queries = ([ForecastQuery(dataset="italy", horizon=14, seed=s) for s in range(4)]
               + [ForecastQuery(dataset="italy", horizon=14, schedule=sched, seed=s)
                  for s in range(4)])
    responses = server.answer(queries)
    assert (server.fits, server.batched_calls, server.kernels.n_compiled) == (0, 4, 2)
    ds, _ = server.dataset("italy", "siard")
    acfg = tabc.ABCConfig(num_days=21)
    for q, resp in zip(queries, responses):
        assert resp == posterior_forecast(post.theta, ds, acfg, q.horizon, schedule=q.schedule,
                                          key=q.seed, max_particles=64, device=cuda)
    # one batched call of two lanes against each lane alone
    spec = get_model("siard")
    _, batched = server.kernels.get(spec, 35, 64, 9, sched)
    theta = np.concatenate([post.theta[:128], np.full((128, 1), 0.5, np.float32)], axis=1)
    theta = theta.reshape(2, 64, 9)
    scalars = np.asarray([[ds.population, ds.a0, ds.r0, ds.d0],
                          [4.917e6, 102.0, 0.0, 0.0]], np.float32)
    seeds = [forecast_seed(1), forecast_seed(2)]
    traj = batched(torch.from_numpy(theta).to(cuda), torch.tensor(seeds),
                   *torch.from_numpy(scalars).T, torch.tensor([[10], [10]]))
    for lane in range(2):
        pop, a0, r0, d0 = (float(x) for x in scalars[lane])
        solo = engine.simulate_observed(
            spec, torch.from_numpy(theta[lane]).to(cuda), seeds[lane],
            EpiModelConfig(population=pop, num_days=35, a0=a0, r0=r0, d0=d0), sched)
        assert torch.equal(traj[lane], solo), lane


def test_forecast_replays_through_the_theta_in_entry(cuda):
    """Particle 0's forecast over the fit window, fed as the observed series
    to the theta-in entry at the same theta, the forecast's seed and the
    dataset's scalars, gives particle 0 a distance of exactly 0 and every
    other particle numpy's Euclidean norm of its difference (rtol 1e-6):
    the forecast core runs the kernel's stream."""
    from repro_torch.core.serving import (
        ForecastKernelCache, _breakpoint_arg, _scalars, forecast_seed)
    from repro_torch.launch.abc_run import parse_intervention

    spec = get_model("siard")
    ds = data.get_dataset("italy", num_days=49)
    for sched in (None, parse_intervention("alpha0@20=0.5")):
        theta = spec.prior().sample(8, 1000, "cpu").numpy()
        if sched is not None:
            theta = np.concatenate([theta, np.full((1000, 1), 0.5, np.float32)], axis=1)
        seed = forecast_seed(3)
        single, _ = ForecastKernelCache().get(spec, 63, 1000, theta.shape[1], sched)
        th = torch.from_numpy(theta).to(cuda)
        traj = single(th, seed, *_scalars(ds), _breakpoint_arg(sched)).cpu().numpy()
        fit = traj[:, :, :49]
        launches = abc_sim.launches("distance")
        dist = ops.abc_sim_distance(th, seed, torch.from_numpy(fit[0]).to(cuda), model=spec,
                                    population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0,
                                    schedule=sched).cpu().numpy()
        assert abc_sim.launches("distance") == launches + 1
        assert dist[0] == 0.0
        want = np.sqrt(((fit.astype(np.float64) - fit[0]) ** 2).sum(axis=(1, 2)))
        np.testing.assert_allclose(dist[1:], want[1:], rtol=1e-6, atol=0)


def test_npe_forward_on_the_card_matches_the_cpu(cuda):
    """The MDN (`core.npe`) at the same weights on the card and on the CPU:
    log_pi, mu, sigma and the log-density within rtol 1e-5, atol 1e-5."""
    from repro_torch.core import npe as tnpe
    from repro_torch.optim.adamw import tree_map

    cfg = tnpe.NPEConfig(hidden=64, n_components=4)
    params = tnpe.mdn_init(3, 30, 3, cfg)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 30)).astype(np.float32))
    th = torch.from_numpy(rng.uniform(size=(256, 3)).astype(np.float32))
    on_card = tree_map(lambda t: t.to(cuda), params)
    for got, want in zip(tnpe.mdn_forward(on_card, x.to(cuda), cfg, 3),
                         tnpe.mdn_forward(params, x, cfg, 3)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tnpe.mdn_log_prob(on_card, x.to(cuda), th.to(cuda), cfg, 3).cpu().numpy(),
        tnpe.mdn_log_prob(params, x, th, cfg, 3).numpy(), rtol=1e-5, atol=1e-5)


def test_npe_is_deterministic_on_the_card(cuda):
    """Two trainings and samplings with one seed on the card are bitwise
    equal, and launch no abc_sim entry."""
    from repro_torch.core import npe as tnpe
    from repro_torch.optim.adamw import tree_leaves

    ds = data.synthetic_dataset(theta=(0.5, 0.2, 1.0), population=1e6, num_days=12,
                                a0=100.0, seed=3, model="sir")
    cfg = tabc.ABCConfig(num_days=12, backend="npe", model="sir", target_accepted=64,
                         npe=tnpe.NPEConfig(train_steps=20, train_batch=64, n_pilot=64,
                                            hidden=32))
    before = (dict(abc_sim.ENTRY_LAUNCHES), ref.CALLS)
    a, b = (tabc.run_abc(ds, cfg, seed=7, device=cuda) for _ in range(2))
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.distances, b.distances)
    e1, e2 = (tnpe.train_npe(ds, cfg, seed=7, device=cuda) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(e1.params), tree_leaves(e2.params)))
    assert e1.device.type == "cuda"
    assert (dict(abc_sim.ENTRY_LAUNCHES), ref.CALLS) == before


# ------------------------------------------------------------------------
# Scale-out on the card (core/distributed.py, core/scaling.py)
# ------------------------------------------------------------------------

_SCALE_KW = dict(batch_size=2 * 16384, chunk_size=4096, num_days=49, target_accepted=30,
                 max_runs=16, wave_loop="device")


def _scale_eps(cuda):
    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(**{**_SCALE_KW, "tolerance": 1.0})
    return tabc.calibrate_tolerance(ds, cfg, seed=0, quantile=1e-3, n_pilot=32768,
                                    device=cuda)


def test_nccl_world_of_one_is_the_unsharded_run_on_the_card(cuda):
    """A world of 1 over NCCL: the unsharded posterior bit for bit, every
    launch the wave entry's, one host sync a segment."""
    from repro_torch.core import distributed

    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(**{**_SCALE_KW, "tolerance": _scale_eps(cuda)})
    solo = tabc.run_abc(ds, cfg, seed=0, device=cuda)
    with distributed.world("cuda") as group:
        assert torch.distributed.get_backend(group) == "nccl"
        runner = distributed.make_wave_runner(group, ds, cfg, device="cuda")
        abc_sim.ENTRY_LAUNCHES.clear()
        abc_sim.ENTRY_GATED.clear()
        syncs = tabc.HOST_SYNCS
        post = tabc.run_abc(ds, cfg, seed=0, wave_runner=runner)
        gated = abc_sim.ENTRY_GATED.get("abc_sim_wave_siard", 0)
        assert dict(abc_sim.ENTRY_LAUNCHES) == {"abc_sim_wave_siard": post.runs + gated}
        assert tabc.HOST_SYNCS - syncs == -(-post.runs // tabc.SEGMENT_WAVES)
    assert not torch.distributed.is_initialized()
    assert (post.runs, post.simulations) == (solo.runs, solo.simulations) and len(post) >= 30
    assert _bits_equal(torch.from_numpy(post.theta), solo.theta)
    assert _bits_equal(torch.from_numpy(post.distances), solo.distances)


def _shared_card_rank(rank, world, kw):
    from repro_torch.core import distributed

    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(**kw)
    runner = distributed.make_wave_runner(torch.distributed.group.WORLD, ds, cfg,
                                          device="cuda:0")
    out = runner(0, 0, runner.init(tabc.ABCState(n_params=8)), tabc.SEGMENT_WAVES)
    waves, n, fills = runner.read(out)
    return runner.segments(out), waves, n, fills


def test_two_gloo_ranks_sharing_one_card_equal_the_two_shard_reference(cuda, tmp_path):
    """NCCL refuses two ranks on one card; over gloo they run, and their
    gathered segments are bitwise the 2-shard lockstep reference's."""
    from repro_torch.core import distributed
    from repro_torch.core.scaling import make_reference_wave_runner

    kw = {**_SCALE_KW, "tolerance": _scale_eps(cuda)}
    got = distributed.spawn_ranks(_shared_card_rank, 2, kw, device="cuda:0", backend="gloo",
                                  timeout=120, tmp_dir=str(tmp_path))
    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(**kw)
    ref_runner = make_reference_wave_runner(get_model("siard").prior(),
                                            tabc.make_simulator(ds, cfg, cuda), cfg, 2)
    out = ref_runner(0, 0, ref_runner.init(tabc.ABCState(n_params=8)), tabc.SEGMENT_WAVES)
    want = ref_runner.read(out)
    want_segments = ref_runner.segments(out)
    assert want[1] >= 30
    for segments, waves, n, fills in got:
        assert (waves, n, fills) == want
        for a, b in zip(segments, want_segments):
            np.testing.assert_array_equal(a, b)


def test_campaign_device_groups_on_one_card(cuda, tmp_path):
    """devices_per_scenario=2 on [cuda:0] * 4: groups "0+1" and "2+3", each
    cell bitwise its solo 2-shard reference run, the resume launching
    nothing."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.campaign import CampaignConfig, run_campaign
    from repro_torch.core.scaling import make_reference_wave_runner

    cfg = CampaignConfig(datasets=("italy", "usa"), models=("siard",), batch_size=32768,
                         num_days=49, target_accepted=30, auto_quantile=1e-3,
                         devices_per_scenario=2, out_dir=str(tmp_path))
    rep = run_campaign(cfg, device=[cuda] * 4)
    assert [(r.status, r.device) for r in rep.scenarios] == [("ok", "0+1"), ("ok", "2+3")]
    cap = tabc.wave_capacity(cfg.abc_config(cfg.scenarios()[0], 1.0), 16384)
    for r in rep.scenarios:
        ds = data.get_dataset(r.dataset, num_days=49)
        shape = cfg.abc_config(cfg.scenarios()[0], 1.0)
        eps = tabc.calibrate_tolerance(ds, shape, seed=0, quantile=cfg.auto_quantile,
                                       n_pilot=cfg.pilot_size, device=cuda)
        solo_cfg = dataclasses.replace(shape, tolerance=eps)
        solo = tabc.run_abc(ds, solo_cfg, seed=0, wave_runner=make_reference_wave_runner(
            get_model("siard").prior(), tabc.make_simulator(ds, solo_cfg, cuda), solo_cfg, 2))
        tree, meta, _ = load_checkpoint(r.checkpoint_dir, {
            "theta_buf": np.zeros((2 * cap, 8), np.float32),
            "dist_buf": np.zeros((2 * cap,), np.float32)})
        rows = np.concatenate([tree["theta_buf"][s * cap:s * cap + c]
                               for s, c in enumerate(meta["fills"])])
        assert _bits_equal(torch.from_numpy(rows), solo.theta)
        assert (eps, solo.runs, solo.simulations) == (r.tolerance, r.runs, r.simulations)
    launches = dict(abc_sim.ENTRY_LAUNCHES)
    rep2 = run_campaign(cfg, device=[cuda] * 4)
    assert [r.status for r in rep2.scenarios] == ["resumed_complete"] * 2
    assert dict(abc_sim.ENTRY_LAUNCHES) == launches


#: (model, R, dataset) of the autotuner's block search: each flat model, the
#: region axis's thread route (R=4) and its warp route (R=100) at 20,000
TUNED_CASES = [("siard", 1, "italy"), ("sir", 1, "synthetic_small"),
               ("seir", 1, "synthetic_small"), ("seiard", 1, "italy"),
               ("metapop_seir", 4, "synthetic_small"), ("metapop_seir", 100, "synthetic_small")]


@pytest.mark.parametrize("model,regions,dataset", TUNED_CASES)
def test_every_candidate_block_is_bitwise_the_default(cuda, model, regions, dataset):
    """The safety contract that lets `core.tuning` apply its winner: at every
    block of `tuning.block_candidates` the wave entry's theta and distances
    and the theta-in entry's distances are the default block's, bit for bit."""
    from repro_torch.core import tuning
    from repro_torch.epi.spec import regionalize

    spec = get_model(model)
    if regions != spec.n_regions:
        spec = regionalize(spec, regions, "ring:0.1")
    batch = 20_000
    if spec.is_regional:
        assert abc_sim.regional_route(spec, batch) == ("thread" if regions == 4 else "warp")
    ds = data.get_dataset(dataset, num_days=49, model=spec)
    cfg = tabc.ABCConfig(batch_size=batch, chunk_size=batch, num_days=49, model=spec)
    prior = schedule_prior(spec)
    sim0 = tabc.make_simulator(ds, cfg, cuda)
    th0, d0 = sim0.wave(prior, 7, 8, batch)
    din0 = sim0(th0, 9)
    blocks = tuning.block_candidates(spec, batch)
    assert len(blocks) >= 3
    for block in blocks:
        sim = tabc.make_simulator(ds, dataclasses.replace(cfg, block=block), cuda)
        th, d = sim.wave(prior, 7, 8, batch)
        assert _bits_equal(th, th0) and _bits_equal(d, d0), block
        assert _bits_equal(sim(th0, 9), din0), block


def test_autotune_on_the_card_records_it_and_a_hit_launches_nothing(cuda, tmp_path):
    from repro_torch.core import tuning

    ds = data.get_dataset("italy", num_days=20)
    cfg = tabc.ABCConfig(batch_size=8192, chunk_size=8192, num_days=20, autotune=True)
    cache = tuning.TuningCache(tmp_path / "cache.json")
    before = abc_sim.launches("wave")
    entry = tuning.autotune(ds, cfg, cache=cache, reps=1, device=cuda)
    assert abc_sim.launches("wave") > before  # the search timed the wave entry
    assert entry["block"] in tuning.block_candidates("siard", 8192)
    assert entry["device"] != "cpu" and "W" in entry["device"]  # name, power limit
    launches = dict(abc_sim.ENTRY_LAUNCHES)
    assert tuning.autotune(ds, cfg, cache=cache, device=cuda) == entry
    assert dict(abc_sim.ENTRY_LAUNCHES) == launches


def test_a_device_loop_segment_synchronizes_once(cuda):
    """The device loop's contract on the card: a segment, enqueued and read,
    makes one synchronizing call (the count read of `sync_counts`), as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    import warnings

    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(batch_size=100_000, chunk_size=10_000, num_days=49,
                         tolerance=2e4, target_accepted=100)
    runner = tabc.make_wave_runner(get_model("siard").prior(),
                                   tabc.make_simulator(ds, cfg, cuda), cfg)
    carry = runner.init(tabc.ABCState(n_params=8))
    torch.cuda.synchronize()
    syncs = tabc.HOST_SYNCS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = runner(0, 0, carry, tabc.SEGMENT_WAVES)
            runner.read(out)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    found = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert len(found) == 1, found
    assert tabc.HOST_SYNCS == syncs + 1


#: the wave entries held at a sample offset: each flat model, SIARD under a
#: one-window schedule, and metapop_seir's region axis on both routes
OFFSET_CASES = ["siard", "sir", "seir", "seiard", "siard_scheduled", "metapop_seir-thread",
                "metapop_seir-warp"]
#: the offsets of chip_smoke.py's phase scaleout_path (g)
OFFSETS = (0, 1, 4096, 50_000)


def _offset_wave(cuda, case):
    """(wave(offset, batch), plain(offset, batch)) of an offset case: the
    wave entry's (theta, dist) and prior.sample + the plain version at the
    same offset, on the card."""
    name, _, route = case.partition("-")
    spec = get_model(name.replace("_scheduled", ""))
    sched = (InterventionSchedule.inferred(("alpha0",), (20,), 0.2, 1.5)
             if name.endswith("_scheduled") else None)
    ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
    kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=cuda), model=spec,
                           schedule=sched, **kw)
    prior = schedule_prior(spec, sched)

    def wave(offset, batch):
        if route:
            return sim.launch("wave", batch, route)(9, 7, prior.lows, prior.highs,
                                                    offset=offset)
        return sim.wave(prior, 7, 9, batch, offset=offset)

    def plain(offset, batch):
        theta = prior.sample(7, batch, cuda, offset=offset)
        d = ref.abc_sim_distance_ref(theta, 9, sim.observed, model=spec, schedule=sched,
                                     sample_offset=offset, **kw)
        return theta, torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)

    return wave, plain


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_wave_entry_at_an_offset_is_the_tail_on_the_card(cuda, case):
    """A wave of b rows at offset o is bitwise rows [o, o + b) of the
    offset-0 wave of o + b rows, and its plain version at the same offset."""
    wave, plain = _offset_wave(cuda, case)
    b = 1024
    for offset in OFFSETS:
        theta, d = wave(offset, b)
        theta0, d0 = wave(0, offset + b)
        assert _bits_equal(theta, theta0[offset:]) and _bits_equal(d, d0[offset:]), offset
        theta_p, d_p = plain(offset, b)
        assert _bits_equal(theta, theta_p) and _bits_equal(d, d_p), offset


@pytest.mark.parametrize("case", ["siard", "metapop_seir-thread", "metapop_seir-warp"])
def test_wave_entry_refuses_an_offset_past_the_32_bit_index(cuda, case):
    """The wrapper refuses offset + batch past 2^32, and so does the C entry
    itself (cudaErrorInvalidValue) when called around the wrapper; the last
    valid offset runs."""
    wave, _ = _offset_wave(cuda, case)
    with pytest.raises(ValueError, match="32-bit sample index"):
        wave(2**32 - 8, 16)
    theta, d = wave(2**32 - 16, 16)
    assert theta.shape[0] == 16 and not torch.isnan(d).any()
    name, _, route = case.partition("-")
    spec = get_model(name)
    ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
    sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=cuda), model=spec,
                           population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
    fn = sim.launch("wave", 16, route or None).fn
    args = list(fn.argtypes)
    assert args[-1] is ctypes.c_uint and len(args) in (14, 19)
    lo = np.ascontiguousarray(spec.prior().lows, np.float32)
    hi = np.ascontiguousarray(spec.prior().highs, np.float32)
    out = torch.empty((16, spec.n_params), device=cuda), torch.empty((16,), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    head = [7, lo.ctypes.data, hi.ctypes.data, sim.obs_summary.data_ptr()]
    if route:
        head += [sim.mob.data_ptr(), sim.weights.data_ptr()]
    head += [out[0].data_ptr(), out[1].data_ptr(), sim.fconst.ctypes.data,
             sim.iconst.ctypes.data, 16, 49]
    if route:
        head += [spec.n_regions, spec.seed_region, 0]
    head += [abc_sim.route_block(route or "thread"), stream, None]
    assert fn(*head, 2**32 - 8) == 1  # cudaErrorInvalidValue
    assert fn(*head, 2**32 - 16) == 0


def test_pjit_world_of_one_over_nccl_is_the_unsharded_run(cuda):
    """The pjit device loop in a world of 1 over NCCL: the unsharded
    posterior bit for bit, one host sync a segment."""
    from repro_torch.core import distributed

    ds = data.get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(**{**_SCALE_KW, "tolerance": _scale_eps(cuda)})
    solo = tabc.run_abc(ds, cfg, seed=0, device=cuda)
    with distributed.world("cuda") as group:
        assert torch.distributed.get_backend(group) == "nccl"
        runner = distributed.make_wave_runner(group, ds, cfg, style="pjit", device="cuda")
        syncs = tabc.HOST_SYNCS
        post = tabc.run_abc(ds, cfg, seed=0, wave_runner=runner)
        assert tabc.HOST_SYNCS - syncs == -(-post.runs // tabc.SEGMENT_WAVES)
    assert not torch.distributed.is_initialized()
    assert (post.runs, post.simulations) == (solo.runs, solo.simulations) and len(post) >= 30
    assert _bits_equal(torch.from_numpy(post.theta), solo.theta)
    assert _bits_equal(torch.from_numpy(post.distances), solo.distances)
