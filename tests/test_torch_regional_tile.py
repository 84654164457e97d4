"""The tile route of the region axis (`csrc/abc_sim_regional_tile.cuh`) on
the card (marker `gpu`; skips without one).

Li et al. 2020's cities (`li2020`) run on it alone, at every R; past
`MAX_REGIONS` every struct does. Each case holds the route to the plain
version on the card (`kernels.ref`, the arithmetic the benchmark's
reference repeats), or to the warp route, bit for bit.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_regional_tile.py
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.epi import engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import EpiModelConfig, regionalize
from repro_torch.kernels import abc_sim, ops, ref

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DAYS = 14


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the port's kernels")
    return torch.device("cuda", 0)


def li2020(regions: int):
    """li2020 over `regions` cities: a seeded traveller matrix (zero
    diagonal, 0-5,000 a day) and populations (0.2-3 million), Wuhan's part
    played by city regions // 3."""
    rng = np.random.default_rng(regions)
    mob = (rng.random((regions, regions)) * 5e3 * (1 - np.eye(regions))).astype(np.float32)
    pops = rng.uniform(2e5, 3e6, regions).astype(np.float32)
    spec = regionalize(get_model("li2020"), regions, mob.tolist(), seed_region=regions // 3)
    return dataclasses.replace(spec, populations=tuple(float(x) for x in pops))


def _sim(cuda, spec, summary=None, a0=1.0):
    """The simulator of a series that the plain version makes at the
    model's default theta, and the keywords of the plain version."""
    cfg = EpiModelConfig(population=5e7, num_days=DAYS, a0=a0)
    theta = torch.tensor([spec.default_theta], dtype=torch.float32)
    obs = engine.simulate_observed(spec, theta, 11, cfg)[0].to(cuda)
    kw = dict(population=cfg.population, a0=cfg.a0, r0=0.0, d0=0.0, model=spec, summary=summary)
    return obs, kw, ops.make_abc_sim(obs, **kw)


def _wave_want(theta, seed, obs, kw, offset=0):
    want = ref.abc_sim_distance_ref(theta, seed, obs, sample_offset=offset, **kw)
    return torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.int32)


@pytest.mark.parametrize("regions,batch", [(12, 1000), (129, 300), (375, 200)])
def test_tile_route_equals_the_plain_version_for_li2020(cuda, regions, batch):
    """Both entries, through `AbcSim` (the route li2020 takes at every R),
    bitwise the plain version: theta and distances, a tile left part-full."""
    spec = li2020(regions)
    assert abc_sim.regional_routes(spec) == ("tile",)
    obs, kw, sim = _sim(cuda, spec)
    assert sim.entry("wave", batch) == "abc_sim_regional_wave_tile_li2020"
    prior = spec.prior()
    theta, dist = sim.wave(prior, 5, 8, batch)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(theta), _bits(prior.sample(5, batch, cuda)))
    assert np.array_equal(_bits(dist), _bits(_wave_want(theta, 8, obs, kw)))
    assert torch.isfinite(dist).all() and (dist > 0).all()
    got = sim(theta, 8)
    assert np.array_equal(_bits(got), _bits(ref.abc_sim_distance_ref(theta, 8, obs, **kw)))


def _tile_slots(sim, batches) -> list:
    """(slots, resident) of `sim`'s tile launches of the wave and the
    theta-in entry at each of `batches`, as `abc_sim.launch` sized them
    when the simulator first called each."""
    return [(ln.slots, ln.resident) for ln in
            (sim.launch(e, b) for b in batches for e in ("wave", "distance"))]


@pytest.mark.parametrize("sms,resident,regions,batch",
                         [(2, 1, 375, 200), (3, 1, 129, 1000), (2, 2, 375, 200),
                          (None, None, 375, 2500)],
                         ids=["2-blocks-375", "3-blocks-129", "2-sms-two-each-375", "card-375"])
def test_tile_route_blocks_walk_several_tiles(cuda, monkeypatch, sms, resident, regions, batch):
    """A grid of fewer blocks than tiles: each block walks tiles blockIdx.x,
    + gridDim.x, ... through one scratch slot, the last tile part-full.
    `sms` x `resident` blocks: the SM count and the blocks resident on each
    patched where given (2 SMs of two blocks: 4 blocks walk 13 tiles), else
    the card's and the occupancy query's (one block an SM at R = 375: the
    card's 2,500 samples are 157 tiles). The whole wave's theta and
    distances bitwise the plain version and the theta-in entry's distances
    too."""
    if sms is not None:
        monkeypatch.setattr(abc_sim, "_sm_count", lambda device: sms)
    if resident is not None:
        monkeypatch.setattr(abc_sim, "_tile_resident", lambda *args: resident)
    spec = li2020(regions)
    obs, kw, sim = _sim(cuda, spec)
    prior = spec.prior()
    theta, dist = sim.wave(prior, 17, 19, batch)
    got = sim(theta, 19)
    torch.cuda.synchronize()
    tiles = -(-batch // abc_sim.TILE_SAMPLES)
    seen = _tile_slots(sim, (batch,))
    assert len(seen) == 2
    for slots, res in seen:
        assert res == (resident or 1)
        assert slots == res * (sms or abc_sim._sm_count(cuda)) < tiles
    assert np.array_equal(_bits(theta), _bits(prior.sample(17, batch, cuda)))
    assert np.array_equal(_bits(dist), _bits(_wave_want(theta, 19, obs, kw)))
    assert np.array_equal(_bits(got), _bits(ref.abc_sim_distance_ref(theta, 19, obs, **kw)))


@pytest.mark.parametrize("regions,model,batches,resident",
                         [(375, "li2020", (1000, 20_000), 1),
                          (200, "metapop_seir", (1000, 20_000), 2)],
                         ids=["li2020-375", "metapop_seir-200"])
def test_tile_overlapped_launches_count_tiles_in_flight(cuda, regions, model, batches,
                                                        resident):
    """The occupancy query's blocks an SM size each launch's scratch: a
    tile launch allocates min(tiles, resident x SMs) slots (fewer tiles
    than that at 1,000 samples, more at 20,000), and `Launch.resident`
    says which launches have two tiles or more in flight an SM: none of
    li2020's at 375 cities (one block of 171 KB an SM), every one of
    metapop_seir's at 200 regions (one coupled input, a 4-warp block)."""
    if model == "li2020":
        spec, a0 = li2020(regions), 1.0
    else:
        spec, a0 = regionalize(get_model("metapop_seir"), regions, "ring:0.1"), 100.0
    _, _, sim = _sim(cuda, spec, a0=a0)
    prior = spec.prior()
    before = abc_sim.route_counts()[0].get("tile", 0)
    for batch in batches:
        theta, _ = sim.wave(prior, 5, 6, batch)
        sim(theta, 6)
    torch.cuda.synchronize()
    seen = _tile_slots(sim, batches)
    launched = abc_sim.route_counts()[0]["tile"] - before
    overlapped = sum(res >= 2 for _, res in seen)
    assert launched == 4 and overlapped == (launched if resident >= 2 else 0)
    sms = abc_sim._sm_count(cuda)
    for (slots, res), batch in zip(seen, [b for b in batches for _ in range(2)]):
        assert res == resident if resident == 1 else res >= resident
        assert slots == min(-(-batch // abc_sim.TILE_SAMPLES), res * sms)


@pytest.mark.parametrize("summary", [None, "region_pooled"])
def test_tile_route_equals_the_plain_version_for_metapop_seir_past_128(cuda, summary):
    """metapop_seir at R = 200 (one coupled input: a 4-warp block, two
    tiles or more resident on each SM), the route it takes past
    MAX_REGIONS: both entries bitwise the plain version, a tile left
    part-full."""
    spec = regionalize(get_model("metapop_seir"), 200, "ring:0.1")
    assert abc_sim.regional_routes(spec) == ("tile",)
    obs, kw, sim = _sim(cuda, spec, summary, a0=100.0)
    prior = spec.prior()
    theta, dist = sim.wave(prior, 23, 24, 1003)
    got = sim(theta, 24)
    torch.cuda.synchronize()
    seen = _tile_slots(sim, (1003,))
    assert np.array_equal(_bits(theta), _bits(prior.sample(23, 1003, cuda)))
    assert np.array_equal(_bits(dist), _bits(_wave_want(theta, 24, obs, kw)))
    assert np.array_equal(_bits(got), _bits(ref.abc_sim_distance_ref(theta, 24, obs, **kw)))
    assert len(seen) == 2 and all(res >= 2 for _, res in seen)


@pytest.mark.parametrize("summary", [None, "region_pooled", "cumulative"])
def test_tile_route_equals_the_warp_route_for_metapop_seir(cuda, summary):
    """metapop_seir at R = 100 on a ring: both entries of the tile route
    bitwise the warp route's (the route R = 100 takes) and the plain
    version's."""
    spec = regionalize(get_model("metapop_seir"), 100, "ring:0.1")
    obs, kw, sim = _sim(cuda, spec, summary, a0=100.0)
    prior = spec.prior()
    theta = prior.sample(3, 1000, cuda)
    got = {}
    for route in ("warp", "tile"):
        d = sim.launch("distance", 1000, route)(9, abc_sim.theta_to_soa(theta))
        th_w, d_w = sim.launch("wave", 1000, route)(9, 3, prior.lows, prior.highs)
        got[route] = [_bits(t) for t in (d, th_w, d_w)]
    for a, b in zip(got["warp"], got["tile"]):
        assert np.array_equal(a, b)
    assert np.array_equal(got["tile"][0], _bits(ref.abc_sim_distance_ref(theta, 9, obs, **kw)))


def test_branch_free_root_and_quotient_are_sqrtf_and_division(cuda):
    """The tau-leap's square root and li2020's quotients skip the IEEE
    branches where their fast paths are sure: bit for bit sqrtf over every
    float, and `/` over 2^30 hashed pairs, most of them on the fast path."""
    got = abc_sim.tile_math_mismatches(cuda, 1 << 30)
    assert got["root"] == 0 and got["div"] == 0
    assert got["root_fast"] > 1 << 30 and got["div_fast"] > 1 << 28


def test_tile_gate_of_zero_writes_nothing(cuda):
    spec = li2020(129)
    _, _, sim = _sim(cuda, spec)
    prior = spec.prior()
    theta = torch.full((64, spec.n_params), -3.0, device=cuda)
    dist = torch.full((64,), -5.0, device=cuda)
    gate = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = abc_sim.route_counts()[0].get("tile", 0)
    sim.wave(prior, 1, 2, 64, gate=gate, out=(theta, dist))
    sim(prior.sample(1, 64, cuda), 2, gate=gate)
    torch.cuda.synchronize()
    assert (theta == -3.0).all() and (dist == -5.0).all()
    assert abc_sim.route_counts()[0]["tile"] == before + 2


def test_tile_wave_at_an_offset_is_a_slice(cuda):
    """A wave of B rows at offset o is rows [o, o + B) of the offset-0
    wave of o + B rows."""
    spec = li2020(129)
    _, _, sim = _sim(cuda, spec)
    prior = spec.prior()
    th_all, d_all = sim.wave(prior, 7, 13, 333)
    th_o, d_o = sim.wave(prior, 7, 13, 133, offset=200)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(th_o), _bits(th_all[200:]))
    assert np.array_equal(_bits(d_o), _bits(d_all[200:]))


def test_tile_route_refuses_past_its_limit(cuda, monkeypatch):
    """R past TILE_MAX_REGIONS: the wrapper raises a ValueError naming the
    limit; past the wrapper, the C entry refuses to launch."""
    spec = regionalize(get_model("metapop_seir"), abc_sim.TILE_MAX_REGIONS + 1, "ring:0.1")
    obs = torch.zeros((spec.total_observed, 5), device=cuda)
    with pytest.raises(ValueError, match=f"TILE_MAX_REGIONS = {abc_sim.TILE_MAX_REGIONS}"):
        ops.make_abc_sim(obs, model=spec, population=1e6, a0=10.0)
    monkeypatch.setattr(abc_sim, "check_regional", lambda *a: None)
    fconst, iconst = abc_sim.pack_consts(population=1e6, a0=10.0, r0=0.0, d0=0.0,
                                         mean_scale=1.0, weights=[], flags=(0, 0, 2, 1, 1),
                                         seed=1)
    mob = torch.full((spec.n_regions, spec.n_regions), 1.0 / spec.n_regions, device=cuda)
    weights = torch.ones((spec.total_observed,), device=cuda)
    theta = abc_sim.theta_to_soa(spec.prior().sample(1, 64, cuda))
    before = dict(abc_sim.ENTRY_LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        abc_sim.launch(spec, "distance", 64, obs=obs, fconst=fconst, iconst=iconst,
                       weights=weights, mobility=mob,
                       tile=abc_sim.tile_buffers(spec, mob, 1e6, cuda))(1, theta)
    assert abc_sim.ENTRY_LAUNCHES == before


def test_route_launches_count_the_route_taken(cuda):
    """`route_counts` sums ENTRY_LAUNCHES and ENTRY_GATED by route: a tile
    launch and a warp launch, and gated launches recorded by name."""
    li = li2020(12)
    mp = regionalize(get_model("metapop_seir"), 100, "ring:0.1")
    launches, gated = abc_sim.route_counts()
    for spec, a0 in ((li, 1.0), (mp, 100.0)):
        _, _, sim = _sim(cuda, spec, a0=a0)
        sim.wave(spec.prior(), 1, 2, 256)
        assert sim.launch("wave", 256).route == ("tile" if spec is li else "warp")
    torch.cuda.synchronize()
    assert abc_sim.route_counts()[0]["tile"] == launches.get("tile", 0) + 1
    assert abc_sim.route_counts()[0]["warp"] == launches.get("warp", 0) + 1
    abc_sim.record_gated(abc_sim.entry_name(li, "wave"), 3)
    assert abc_sim.route_counts()[1]["tile"] == gated.get("tile", 0) + 3
