"""The warp route of the region axis on the CPU: the choice of route, the
warp kernel's shared memory and its refusals, its SASS census and floor on
a hand-written excerpt, and its summation order held to the plain version.

The kernel itself (`csrc/abc_sim_regional_warp.cuh`) runs on the card only:
`tests/test_torch_gpu.py` holds both routes bitwise to the plain version
there, and `chip_smoke.py` times them.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import abc as tabc
from repro_torch.epi import engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import make_mobility, regionalize
from repro_torch.kernels import abc_sim, ops, sass

torch.set_num_threads(1)

MP = get_model("metapop_seir")


def _mp(R):
    return MP if R == 4 else regionalize(MP, R, "ring:0.1")


# ------------------------------------------------------------ the route
#: (least batch, least R of the warp route), as measured (PERF.md)
CROSSOVER = ((0, 12), (50_000, 18), (100_000, 24))


@pytest.mark.parametrize("batch", [1, 20_000, 49_999, 50_000, 65_536, 100_000, 1_000_000])
@pytest.mark.parametrize("R", [1, 2, 4, 10, 11, 12, 17, 18, 23, 24, 32, 33, 64, 100, 128])
def test_regional_route_follows_the_crossover(R, batch):
    """The thread route below the crossover of the launch's batch (12 below
    50,000 samples, 18 below 100,000, 24 from there: the thread route gains
    more from a full card), the warp route from there; names, symbols and
    blocks follow the route."""
    assert abc_sim.WARP_MIN_REGIONS == CROSSOVER
    least = [r for b, r in CROSSOVER if batch >= b][-1]
    assert abc_sim.warp_min_regions(batch) == least
    spec = _mp(R)
    want = "warp" if R >= least else "thread"
    assert abc_sim.regional_route(spec, batch) == want
    routes = tuple(r for r in ("thread", "warp")
                   if (r == "warp") == (R >= 12) or (r == "thread") == (R < 24))
    assert abc_sim.regional_routes(spec) == routes
    if len(routes) == 1:
        assert abc_sim.regional_route(spec) == want
        warp = "warp_" if want == "warp" else ""
        assert abc_sim.entry_name(spec, "wave") == f"abc_sim_regional_wave_{warp}metapop_seir"
    else:
        with pytest.raises(ValueError, match="give the batch or the route"):
            abc_sim.regional_route(spec)
    assert abc_sim.entry_name(spec, "distance", "warp") == \
        "abc_sim_regional_distance_warp_metapop_seir"
    assert abc_sim.entry_name(spec, "distance", "thread") == \
        "abc_sim_regional_distance_metapop_seir"
    kernel = "abc_sim_regional_warp_kernel" if want == "warp" else "abc_sim_regional_kernel"
    assert abc_sim.variant_symbol(spec, 8, want) == f"{kernel}I11MetapopSeirLi8EE"
    assert abc_sim.route_block(want) == (512 if want == "warp" else 256)
    assert abc_sim.library(spec) == "abc_sim_regional_metapop_seir"


def test_routes_and_blocks_refuse_what_the_kernels_do_not_take():
    spec = _mp(100)
    with pytest.raises(ValueError, match="flat"):
        abc_sim.regional_route(get_model("siard"))
    with pytest.raises(ValueError, match="route must be one of"):
        abc_sim.entry_name(spec, "wave", "block")
    assert abc_sim.route_block("warp") == abc_sim.WARP_DEFAULT_BLOCK == 512
    assert abc_sim.route_block("thread") == abc_sim.DEFAULT_BLOCK == 256
    assert abc_sim.route_block("warp", 384) == 384
    for route, bad in (("warp", 1024), ("warp", 100), ("thread", 512)):
        with pytest.raises(ValueError, match="multiple of 32"):
            abc_sim.route_block(route, bad)
    abc_sim.check_kernel_block(get_model("siard"))
    abc_sim.check_kernel_block(spec, 512)
    for model, bad in ((get_model("siard"), 512), (_mp(16), 384), (_mp(4), 512)):
        # R=16 may take either route, so a block must suit both
        with pytest.raises(ValueError, match="multiple of 32"):
            abc_sim.check_kernel_block(model, bad)
    abc_sim.check_kernel_block(_mp(16), 256)
    # the config takes each kernel's own bound; None is the kernel's default
    assert tabc.ABCConfig(batch_size=256, chunk_size=256).block is None
    tabc.ABCConfig(batch_size=256, chunk_size=256, model=spec, block=512)
    with pytest.raises(ValueError, match="multiple of 32"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, block=512)
    with pytest.raises(ValueError, match="multiple of 32"):
        tabc.ABCConfig(batch_size=256, chunk_size=256, model=_mp(16), block=512)


@pytest.mark.parametrize("model,regions,want", [
    ("siard", None, "abc_sim_wave_siard"),
    ("metapop_seir", 4, "abc_sim_regional_wave_metapop_seir"),
    ("metapop_seir", 100, "abc_sim_regional_wave_warp_metapop_seir"),
    ("li2020", None, "abc_sim_regional_wave_tile_li2020")],
    ids=["flat", "thread", "warp", "tile"])
def test_simulator_names_its_entry_without_the_library(model, regions, want):
    """`AbcSim.entry("wave", 100,000)` on the CPU, where no library loads:
    the C name the card's launch counts under (`perfbench` and the trace
    audit read it), on each route."""
    spec = get_model(model) if regions is None else _mp(regions)
    sim = ops.make_abc_sim(torch.zeros(spec.total_observed, 10), population=1e6, a0=10.0,
                           model=spec)
    assert sim.entry("wave", 100_000) == want
    assert abc_sim.entry_route(want) == ("flat" if model == "siard"
                                         else abc_sim.regional_route(spec, 100_000))


def test_wrappers_launch_only_on_the_card():
    """A CPU tensor never reaches the C entries: the wrappers refuse it
    before any launch (the plain version is `ops`' CPU path)."""
    spec = _mp(40)
    n = spec.total_observed
    launches = dict(abc_sim.ENTRY_LAUNCHES)
    fconst, iconst = abc_sim.pack_consts(population=1e6, a0=10.0, r0=0.0, d0=0.0,
                                         mean_scale=1.0, weights=[], flags=(0, 0, 2, 1, 1),
                                         seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        abc_sim.launch(spec, "wave", 64, obs=torch.zeros(n, 5), fconst=fconst, iconst=iconst,
                       weights=torch.zeros(n), mobility=torch.zeros(40, 40), route="warp")
    assert abc_sim.ENTRY_LAUNCHES == launches


# ------------------------------------------------------------ shared memory
def test_warp_route_shared_memory_layout():
    """Each warp's vectors ((N_COUPLED + N_OBS) * 128 floats), the matrix in
    groups of four sources with 128 floats of padding, the observed summary
    and the weights."""
    spec = _mp(100)
    got = abc_sim.regional_smem_bytes(spec, 1, 49, "warp", 512)
    assert got == 4 * (16 * (1 + 2) * 128 + (4 * 25 * 100 + 128) + 200 * 50)
    assert abc_sim.regional_smem_bytes(spec, 1, 49) == got  # R=100 takes the warp route
    assert abc_sim.regional_smem_bytes(spec, 1, 49, "thread") == 4 * (200 * 50 + 100 * 100)
    assert abc_sim.regional_smem_bytes(spec, 100, 49, "warp", 32) == \
        4 * (1 * 3 * 128 + (4 * 25 * 100 + 128) + 2 * 50)
    s3 = regionalize(get_model("seir"), 33)  # uncoupled: no matrix
    assert abc_sim.regional_smem_bytes(s3, 1, 10, "warp", 64) == \
        4 * (2 * 2 * 128 + 66 * 11)
    r37 = _mp(37)  # ceil(37 / 4) = 10 groups
    assert abc_sim.regional_smem_bytes(r37, 1, 7, "warp", 256) == \
        4 * (8 * 3 * 128 + (4 * 10 * 37 + 128) + 74 * 8)


def test_warp_route_refuses_past_the_opt_in_limit():
    """At R=128 and 150 days the warp route's block of 512 needs more shared
    memory than the card gives, a block of 32 does not; the thread route's
    block fits. Every refusal is a ValueError before any launch."""
    spec = _mp(128)
    n = spec.total_observed
    obs, mob, w = torch.zeros(n, 150), torch.zeros(128, 128), torch.zeros(n)
    launches = dict(abc_sim.ENTRY_LAUNCHES)
    assert abc_sim.regional_smem_bytes(spec, 1, 150, "warp", 512) > abc_sim.SMEM_OPTIN_BYTES
    with pytest.raises(ValueError, match="shared memory a block on the warp route"):
        abc_sim.check_regional(spec, obs, mob, w, 1, "warp", 512)
    with pytest.raises(ValueError, match="shared memory a block on the warp route"):
        abc_sim.check_regional(spec, obs, mob, w, 1)  # R=128: warp, its default block
    abc_sim.check_regional(spec, obs, mob, w, 1, "warp", 32)
    abc_sim.check_regional(spec, obs, mob, w, 1, "thread")
    # R=16 may take either route: with no route, each must fit
    r16 = _mp(16)
    o16, m16, w16 = torch.zeros(32, 1700), torch.zeros(16, 16), torch.zeros(32)
    abc_sim.check_regional(r16, o16, m16, w16, 1, "thread")
    with pytest.raises(ValueError, match="shared memory a block on the warp route"):
        abc_sim.check_regional(r16, o16, m16, w16, 1)
    with pytest.raises(ValueError, match="MAX_REGIONS = 128"):
        abc_sim.check_regional(_mp(129), torch.zeros(258, 5), torch.zeros(129, 129),
                               torch.zeros(258), 1, "warp", 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        abc_sim.check_regional(spec, obs, mob, w, 1, "warp", 1024)
    assert abc_sim.ENTRY_LAUNCHES == launches


# ------------------------------------------------------------ summation order
def _warp_rows(mob: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The warp kernel's coupled rows, written out: row = -0, then row + m *
    x over the sources in groups of four, the group past R padded with m =
    +0 and x = -0."""
    R = mob.shape[0]
    padded = -(-R // 4) * 4
    m = torch.zeros((R, padded), dtype=torch.float32)
    m[:, :R] = mob
    xs = torch.full((x.shape[0], padded), -0.0, dtype=torch.float32)
    xs[:, :R] = x
    row = torch.full((x.shape[0], R), -0.0, dtype=torch.float32)
    for q in range(padded):
        row = row + m[:, q] * xs[:, q:q + 1]
    return row


@pytest.mark.parametrize("R,grammar", [(12, "ring:0.1"), (33, "uniform:0.2"), (100, "ring:0.1"),
                                       (128, "identity")])
def test_warp_rows_equal_the_plain_coupled_rows_bitwise(R, grammar):
    """Starting a row at -0 and padding the last group with +0 * -0 gives
    the plain version's rows (engine.coupled_rows: the first product, then
    left to right) bit for bit, zeros and their signs included."""
    rng = np.random.default_rng(R)
    spec = regionalize(MP, R, grammar)
    mob = torch.tensor(make_mobility(grammar, R), dtype=torch.float32)
    infectious = rng.integers(0, 3, size=(64, R)) * rng.uniform(0.0, 1e4, size=(64, R))
    infectious[0] = 0.0  # every product +0: the row must stay +0
    infectious[1, :] = -0.0  # -0 sources: the row is -0 in both
    x = torch.tensor(infectious, dtype=torch.float32)
    state = torch.zeros((64, R, spec.n_state), dtype=torch.float32)
    state[..., spec.coupled_idx[0]] = x
    (want,) = engine.coupled_rows(spec, state, mob)
    got = _warp_rows(mob, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_chain_with_zero_padding_equals_the_sequential_sum():
    """acc + 0 leaves acc as it is for every acc the chain can hold (it
    starts at +0 and never becomes -0), so the warp route's chain over
    channels padded to a multiple of 8 with +0 is the sequential one."""
    rng = np.random.default_rng(3)
    for n_chan in (1, 7, 8, 9, 200, 256):
        v = rng.uniform(0.0, 1e3, size=(32, n_chan)).astype(np.float32)
        v[0] = 0.0
        v[1, ::3] = -0.0  # flush 0 and a term times a negative weight
        v[2, 5 % n_chan] = np.inf
        want = np.zeros((32,), np.float32)
        for ch in range(n_chan):
            want = want + v[:, ch]
        padded = np.zeros((32, -(-n_chan // 8) * 8), np.float32)
        padded[:, :n_chan] = v
        got = np.zeros((32,), np.float32)
        for ch in range(padded.shape[1]):
            got = got + padded[:, ch]
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------ the census
def _listing(rows):
    """A cuobjdump-style function from (label, instruction) rows, branch
    targets given by label."""
    addr = {label: 16 * n for n, (label, _) in enumerate(rows) if label}
    lines = ["\tFunction : _ZN12_GLOBAL__N_128abc_sim_regional_warp_kernelI11MetapopSeirLi8EEEvv"]
    for n, (_, ins) in enumerate(rows):
        for label, a in addr.items():
            ins = ins.replace(f" {label} ;", f" {a:#x} ;") if ins.endswith(f" {label} ;") else ins
        lines.append(f"        /*{16 * n:04x}*/                   {ins}")
    return "\n".join(lines) + "\n"


def _rows_loop(label, nr):
    return ([(label, "LDS.128 R4, [R5] ;")] + [("", "FMUL R6, R4, R4 ;")] * nr
            + [("", "FADD R7, R7, R6 ;")] * nr + [("", f"@P1 BRA {label} ;"),
                                                   ("", "BRA passes ;")])


#: the warp kernel's day, by label: the segment loop holds the day loop,
#: whose steps are the coupled rows' loops for NR = 1..4 regions a lane
#: (1..4 FMULs), pass 0, the guards of passes 1-3 (each jumping past pass
#: 3), the branch around the pooled sums (their loop and the pooled
#: channels), and the chain's loop (16-byte loads)
WARP_ROWS = ([("", "S2R R0, SR_TID.X ;"), ("seg", "FADD R1, R1, R1 ;"),
              ("day", "IADD3 R2, R2, 0x1, RZ ;"), ("", "@P0 BRA rows2 ;")]
             + _rows_loop("rows1", 1) + _rows_loop("rows2", 2) + _rows_loop("rows3", 3)
             + _rows_loop("rows4", 4)
             + [("passes", "MUFU.RSQ R8, R8 ;"), ("", "FFMA R9, R9, R9, R9 ;"),
                ("", "@P2 BRA after ;"), ("", "MUFU.RSQ R8, R8 ;"), ("", "FMUL R9, R9, R9 ;"),
                ("", "@P3 BRA after ;"), ("", "MUFU.RSQ R8, R8 ;"), ("", "FMUL R9, R9, R9 ;"),
                ("", "@P4 BRA after ;"), ("", "MUFU.RSQ R8, R8 ;"), ("", "FMUL R9, R9, R9 ;"),
                ("", "LOP3.LUT R10, R10, R10, RZ, 0x96, !PT ;"),
                ("after", "@P5 BRA chain ;"),
                ("pool", "LDS R11, [R1] ;"), ("", "FADD R12, R12, R11 ;"),
                ("", "@P6 BRA pool ;"), ("", "FMUL R13, R13, R13 ;"), ("", "BRA next ;"),
                ("chain", "LDS.128 R14, [R1] ;"), ("", "LDS.128 R18, [R1+0x10] ;"),
                ("", "FADD R22, R22, R14 ;"), ("", "@P6 BRA chain ;"),
                ("next", "IADD3 R23, R23, 0x1, RZ ;"), ("", "@P0 BRA day ;"),
                ("", "IADD3 R24, R24, 0x1, RZ ;"), ("", "@P0 BRA seg ;"), ("", "EXIT ;")])


def test_regional_warp_census_counts_each_step():
    body = next(iter(sass.parse_functions(_listing(WARP_ROWS)).values()))
    cen = sass.regional_warp_census(body, coupled=True)
    assert cen["shape_ok"] and len(cen["pass_guards"]) == 3
    # the day's own path: its head, the dispatch, the branch out of the NR=2
    # loop, pass 0 (2), passes 1-3 with their guards (3, 3, 4), the branch
    # to the chain, the day's end (2)
    assert cen["day"]["total"] == 18
    assert [p["total"] for p in cen["passes"]] == [3, 3, 4]
    assert {nr: c["total"] for nr, c in cen["coupled_rows"].items()} == {1: 4, 2: 6, 3: 8, 4: 10}
    assert cen["chain"]["total"] == 4 and cen["pooled_sum"]["total"] == 3
    assert cen["per_sample_outside_loop"]["total"] == 2
    pooled = sass.regional_warp_census(body, coupled=True, pooled=True)
    assert pooled["day"]["total"] == 20  # the pooled channels and the branch past the chain
    # R=100, 200 channels: 4 passes, 25 groups of sources, 25 chain trips
    assert sass.regional_warp_per_day(cen, 100, 200)["total"] == 18 + 25 * 10 + 25 * 4
    # R=40, 80 channels: passes 2 and 3 drop out, NR=2 rows, 10 chain trips
    assert sass.regional_warp_per_day(cen, 40, 80)["total"] == 18 - 7 + 10 * 6 + 10 * 4
    assert sass.regional_warp_per_day(pooled, 100, 2)["total"] == 20 + 25 * 10 + 99 * 3
    # one warp-instruction is one issue slot (4 a clock an SM) for one sample
    floor = sass.regional_warp_issue_floor_ms(cen, 100, 200, 20_000, 49, 132, 1980.0)
    assert floor["bound_by"] == "issue"
    assert floor["warp_instructions_per_sample_day"] == pytest.approx(368 + 2 / 49)
    assert floor["floor_ms"] == pytest.approx(
        20_000 * (49 * 368 / 4 + 2 / 4) / 132 / 1980e6 * 1e3)
    # an uncoupled day has no row loops before its passes
    assert not sass.regional_warp_census(body, coupled=False)["shape_ok"]


def test_regional_warp_census_reports_another_shape():
    rows = [(label, "FMUL R8, R8, R8 ;" if ins.startswith("MUFU") and n % 2 else ins)
            for n, (label, ins) in enumerate(WARP_ROWS)]
    body = next(iter(sass.parse_functions(_listing(rows)).values()))
    bad = sass.regional_warp_census(body, coupled=True)
    assert not bad["shape_ok"] and len(bad["pass_guards"]) != 3
    assert sass.regional_warp_issue_floor_ms(bad, 100, 200, 20_000, 49, 132, 1980.0) is None
