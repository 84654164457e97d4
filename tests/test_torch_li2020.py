"""Li et al. 2020's cities in the port's spec and plain path (`li2020`):
what the spec now takes (inflow and outflow rows, populations a region,
traveller counts, coupled-input and region-constant hooks) and still
refuses, the route the region axis takes for it, and the existing models'
plain paths bit for bit as before these were added. The plain path against
the benchmark's reference is `perfbench/test_perfbench_li2020.py`; the
tile route on the card `tests/test_torch_regional_tile.py`."""

import contextlib
import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core.priors import schedule_prior
from repro_torch.epi import engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import (
    MAX_TRANSITIONS,
    EpiModelConfig,
    regionalize,
    validate_mobility,
)
from repro_torch.kernels import abc_sim, ref, sass

torch.set_num_threads(1)

LI = get_model("li2020")
SIR = get_model("sir")
#: a traveller matrix of 5 cities: counts, rows far from summing to 1
COUNTS = tuple(tuple(0.0 if q == r else 100.0 * (r + 1) + q for q in range(5))
               for r in range(5))


def _flat_with(row):
    """sir with one more transition row."""
    return dataclasses.replace(SIR, stoichiometry=SIR.stoichiometry + (row,))


#: (what, a spec build that must pass, or one that must raise with `match`)
SPEC_CASES = {
    "li2020 registered": (lambda: LI, None),
    "traveller counts": (lambda: regionalize(LI, 5, COUNTS, seed_region=3), None),
    "populations": (lambda: dataclasses.replace(regionalize(LI, 5, COUNTS),
                                                populations=(1e5, 2e5, 3e5, 4e5, 5e5)), None),
    "inflow and outflow on a regional spec": (
        lambda: dataclasses.replace(regionalize(SIR, 2), stoichiometry=SIR.stoichiometry
                                    + ((0, 1, 0), (0, -1, 0))), None),
    "two sources": (lambda: _flat_with((-1, -1, 1)), "one source to one destination"),
    "no move at all": (lambda: regionalize(_flat_with((0, 0, 0)), 2), "one source"),
    "inflow on a flat spec": (lambda: _flat_with((0, 1, 0)), "one source"),
    "populations of another length": (
        lambda: dataclasses.replace(regionalize(LI, 5, COUNTS), populations=(1e5,) * 4),
        "populations must be 5"),
    "a population of zero": (
        lambda: dataclasses.replace(regionalize(LI, 5, COUNTS), populations=(0.0,) * 5),
        "positive finite"),
    "negative counts": (lambda: regionalize(LI, 2, ((0.0, -1.0), (1.0, 0.0))),
                        "non-negative"),
    "infinite counts": (lambda: regionalize(LI, 2, ((0.0, float("inf")), (1.0, 0.0))),
                        "finite"),
    "counts where weights are wanted": (
        lambda: regionalize(get_model("metapop_seir"), 5, COUNTS), "row-stochastic"),
    "too many transitions a region": (
        lambda: dataclasses.replace(LI, stoichiometry=LI.stoichiometry * 2),
        f"at most {MAX_TRANSITIONS}"),
    "a flat spec past its day's slots": (
        lambda: dataclasses.replace(SIR, stoichiometry=SIR.stoichiometry * 5), "at most 8"),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_takes_what_li2020_needs_and_refuses_malformed_rows(case):
    build, match = SPEC_CASES[case]
    if match is None:
        spec = build()
        assert spec.is_regional
        return
    with pytest.raises(ValueError, match=match):
        build()


def test_li2020_declares_the_paper_and_keeps_its_populations():
    assert LI.compartments == ("S", "E", "Ir", "Iu", "Rr", "Ru")
    assert LI.observed == ("Ir", "Rr") and LI.coupled == ("S", "E", "Iu")
    assert LI.prior().lows == (0.8, 0.2, 1.0, 2.0, 2.0, 0.02, 0.0, 0.0)
    assert LI.prior().highs == (1.5, 1.0, 1.75, 5.0, 5.0, 1.0, 2000.0, 2000.0)
    assert LI.transition_sources == (0, 1, 1, 2, 3, None, 0, None, 1, None, 3)
    assert LI.transition_destinations == (1, 2, 3, 4, 5, 0, None, 1, None, 3, None)
    assert validate_mobility(COUNTS, 5, counts=True) == COUNTS
    spec = dataclasses.replace(regionalize(LI, 5, COUNTS), populations=(1e5,) * 5)
    assert regionalize(spec, 5, COUNTS).populations == (1e5,) * 5
    assert regionalize(spec, 6, None).populations is None
    assert regionalize(LI, 375, None).ctr_slots == 4128


def test_the_tile_route_alone_takes_li2020():
    for R in (4, 12, 375):
        spec = regionalize(LI, R, None)
        assert abc_sim.tile_only(spec) and abc_sim.regional_routes(spec) == ("tile",)
        assert abc_sim.regional_route(spec, 20_000) == "tile"
        assert abc_sim.entry_name(spec, "wave") == "abc_sim_regional_wave_tile_li2020"
    spec = regionalize(LI, 375, None)
    assert abc_sim.library(spec) == "abc_sim_regional_li2020"
    assert abc_sim.tile_rpad(375) == 384
    # vt [384][48], two chunks [16][384], the channels [750][16], theta [16][8]
    assert abc_sim.regional_smem_bytes(spec, 1, 14) == 4 * (384 * 48 + 2 * 16 * 384
                                                              + 750 * 16 + 16 * 8)
    assert abc_sim.regional_smem_bytes(spec, 1, 14) <= abc_sim.SMEM_OPTIN_BYTES
    obs, mob, w = torch.zeros(750, 14), torch.zeros(375, 375), torch.zeros(750)
    abc_sim.check_regional(spec, obs, mob, w, 1)
    for route in ("thread", "warp"):
        with pytest.raises(ValueError, match="MAX_REGIONS = 128"):
            abc_sim.check_regional(spec, obs, mob, w, 1, route)
    small = regionalize(LI, 12, None)
    with pytest.raises(ValueError, match="tile route alone"):
        abc_sim.check_regional(small, torch.zeros(24, 14), torch.zeros(12, 12),
                               torch.zeros(24), 1, "warp")
    metapop = regionalize(get_model("metapop_seir"), 200, "ring:0.1")
    assert abc_sim.regional_routes(metapop) == ("tile",)
    assert abc_sim.variant_symbol(metapop, 8) == \
        "abc_sim_regional_tile_kernelI11MetapopSeirLi8EE"


@pytest.mark.parametrize("resident,sms,batch,slots",
                         [(1, 132, 20_000, 132), (2, 132, 20_000, 264), (3, 4, 20_000, 12),
                          (2, 132, 2_000, 125), (2, 2, 9, 1)],
                         ids=["one-an-sm", "two-an-sm", "three-an-sm", "fewer-tiles",
                              "one-part-full-tile"])
def test_tile_scratch_is_sized_from_the_residency(monkeypatch, resident, sms, batch, slots):
    """The tile route's scratch and grid, with the library, the occupancy
    query and the SM count faked (no card here): min(tiles, resident x SMs)
    slots of `slot_floats` each, handed to the entry as its slots; the query
    asked for the launch's own variant, once, when `abc_sim.launch` makes
    the launch; `Launch.resident` keeps its blocks an SM, and
    `route_counts` counts every launch on the tile route."""
    spec = regionalize(LI, 375, None)
    R, rpad = 375, abc_sim.tile_rpad(375)
    tile = abc_sim.TileBuffers(torch.zeros(rpad, rpad), torch.ones(R), torch.ones(1, R), 1000)
    asked, got, scratch = [], [], []

    def entry(*args):
        got.append(args)
        return 0

    empty = torch.empty
    monkeypatch.setattr(abc_sim, "ENTRY_LAUNCHES", {})
    monkeypatch.setattr(abc_sim, "_lib", lambda name: types.SimpleNamespace(
        abc_sim_regional_wave_tile_li2020=entry))
    monkeypatch.setattr(abc_sim, "_check_cuda", lambda name, t: None)
    monkeypatch.setattr(abc_sim, "_check_struct", lambda lib, model: None)
    monkeypatch.setattr(abc_sim, "_tile_resident",
                        lambda lib, kernel, n, v, device: asked.append((kernel, n, v)) or resident)
    monkeypatch.setattr(abc_sim, "_sm_count", lambda device: sms)
    monkeypatch.setattr(abc_sim, "_stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: scratch.append(shape) or
                        empty(shape, **kw))
    flags = (1, 0, 2, 1, 1)
    fconst, iconst = abc_sim.pack_consts(population=1e6, a0=1.0, r0=0.0, d0=0.0,
                                         mean_scale=1.0, weights=[], flags=flags, seed=3)
    ln = abc_sim.launch(spec, "wave", batch, obs=torch.zeros(2 * R, 14), fconst=fconst,
                        iconst=iconst, weights=torch.ones(2 * R), mobility=torch.zeros(R, R),
                        tile=tile)
    assert (ln.route, ln.name) == ("tile", "abc_sim_regional_wave_tile_li2020")
    assert (ln.slots, ln.resident) == (slots, resident)
    assert ln.slots == min(-(-batch // abc_sim.TILE_SAMPLES), resident * sms)
    prior = spec.prior()
    out = (torch.zeros(batch, spec.n_params), torch.zeros(batch))
    for _ in range(2):
        ln(3, 7, prior.lows, prior.highs, out=out)
    assert asked == [("li2020", R, abc_sim.variant(flags, True))]
    assert scratch == [(slots * 1000,)] * 2
    head = 3  # the prior seed and the box
    assert got[-1][head + 6] == slots  # after obs, the matrix, pops, rconst, weights, scratch
    assert abc_sim.route_counts()[0] == {"tile": 2}


#: a tile kernel's shape in SASS: the tile loop (0x10, a MUFU of its own),
#: the day loop (0x20) holding the coupled rows (0x20), the region pass
#: (0x60, with a cold call and a slow loop behind a branch) and the chain
#: (0x110)
TILE_SASS = """
        Function : _ZN12_GLOBAL__N_128abc_sim_regional_tile_kernelI6Li2020Li8EEEvv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   MUFU.RSQ R1, R1 ;
        /*0020*/                   FMUL R2, R2, R2 ;
        /*0030*/                   FADD R3, R3, R2 ;
        /*0040*/               @P0 BRA 0x20 ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   MUFU.LG2 R4, R4 ;
        /*0070*/                   MUFU.COS R5, R5 ;
        /*0080*/               @P1 BRA 0xd0 ;
        /*0090*/                   CALL.REL.NOINC 0x200 ;
        /*00a0*/                   LDL R6, [R1] ;
        /*00b0*/               @P2 BRA 0xa0 ;
        /*00c0*/                   MUFU.RCP R7, R7 ;
        /*00d0*/                   FADD R8, R8, R8 ;
        /*00e0*/                   MUFU.RCP R9, R9 ;
        /*00f0*/                   STG.E [R10.64], R8 ;
        /*0100*/               @P3 BRA 0x60 ;
        /*0110*/                   FADD R11, R11, R11 ;
        /*0120*/               @P4 BRA 0x110 ;
        /*0130*/               @P5 BRA 0x20 ;
        /*0140*/               @P6 BRA 0x10 ;
        /*0150*/                   EXIT ;
        /*0200*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_tile_region_census_counts_one_city_day():
    """The region pass is the loop whose own code holds the most MUFU; one
    trip skips the cold call (and the slow loop behind it): 7 instructions,
    3 of them quarter-rate, so the floor of 375 cities is quarter-bound."""
    body = next(iter(sass.parse_functions(TILE_SASS).values()))
    cen = sass.tile_region_census(body)
    assert cen["shape_ok"] and cen["span"] == ["0060", "0100"]
    per = cen["per_city_day"]
    assert (per["total"], per["quarter"], per["fp32"], per["memory"], per["branch"]) == \
        (7, 3, 1, 1, 2)
    floor = sass.tile_region_floor_ms(cen, 375, 20_000, 14, 132, 1980.0)
    assert floor["bound_by"] == "quarter" and floor["instructions_per_city_day"] == 7
    assert floor["floor_ms"] == pytest.approx(375 * 3 / 16 * 20_000 * 14 / 132 / 1.98e9 * 1e3)
    flat = sass.parse_functions(TILE_SASS.replace("MUFU", "FMUL"))
    assert not sass.tile_region_census(next(iter(flat.values())))["shape_ok"]
    assert sass.tile_region_floor_ms({"shape_ok": False}, 375, 1, 1, 1, 1.0) is None


@pytest.mark.parametrize("name", ["abc_sim_wave_siard", "abc_sim_regional_wave_seir",
                                  "abc_sim_regional_distance_warp_metapop_seir",
                                  "abc_sim_regional_wave_tile_li2020"])
def test_entry_route_names_each_route(name):
    want = {"abc_sim_wave_siard": "flat", "abc_sim_regional_wave_seir": "thread",
            "abc_sim_regional_distance_warp_metapop_seir": "warp",
            "abc_sim_regional_wave_tile_li2020": "tile"}
    assert abc_sim.entry_route(name) == want[name]


def test_inflow_clamps_at_zero_alone_and_outflow_to_its_source():
    """Rows applied in row order: an inflow's count is max(n, 0) however
    little its compartment holds; an outflow drains what earlier rows left
    of its source; what an inflow adds is no later row's budget."""
    spec = LI
    sc = [torch.tensor([10.0]), torch.tensor([3.0]), torch.tensor([0.0]), torch.tensor([1.0]),
          torch.tensor([0.0]), torch.tensor([0.0])]
    raw = [torch.tensor([v]) for v in (4.0, 1.0, 1.0, 0.0, 0.0, 50.0, 9.0, -2.0, 5.0,
                                       7.0, 3.0)]
    s, e, ir, iu, rr, ru = (float(x) for x in engine.drain_and_apply(spec, sc, raw))
    # S: -4 (S->E), +50 (-> S), -min(9, 10 - 4) (S ->)
    assert s == 10.0 - 4.0 + 50.0 - 6.0
    # E: +4, -1, -1, +0 (the inflow of -2 clamps at zero), -min(5, 3 - 2)
    assert e == 3.0 + 4.0 - 1.0 - 1.0 + 0.0 - 1.0
    # Iu: +1 (E->Iu), +7 (-> Iu), -min(3, 1) (Iu ->): the inflow is no budget
    assert (ir, iu, rr, ru) == (1.0, 1.0 + 1.0 + 7.0 - 1.0, 0.0, 0.0)


#: (ctr_slots, sha256 of theta, the series and the distances) of the plain
#: path, computed with the code from before the region axis took li2020
GOLDEN = {"siard": (8, "6828033dac10bdcbc1dfa299e8229792"),
          "metapop_ring12": (40, "8c14e67093628500950ca4ae8e7a98e3")}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_existing_plain_paths_are_bitwise_as_before(name):
    """siard and metapop_seir on a ring of 12 (seed region 5): the prior's
    draw, a simulated series and the plain version's distances hash as
    they did before the spec took inflows, populations, counts and hooks."""
    spec = (get_model("siard") if name == "siard"
            else regionalize(get_model("metapop_seir"), 12, "ring:0.1", seed_region=5))
    cfg = EpiModelConfig(population=1e6, num_days=12, a0=100.0, r0=2.0, d0=1.0)
    theta = schedule_prior(spec).sample(3, 64, torch.device("cpu"))
    obs = engine.simulate_observed(spec, theta, 9, cfg)
    dist = ref.abc_sim_distance_ref(theta, 4, obs[0], population=1e6, a0=100.0, r0=2.0,
                                    d0=1.0, model=spec, sample_offset=7)
    h = hashlib.sha256()
    for t in (theta, obs, dist):
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    assert (spec.ctr_slots, h.hexdigest()[:32]) == GOLDEN[name]
