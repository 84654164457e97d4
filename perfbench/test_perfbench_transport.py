"""The reference's hooks for a public regional model, on a toy in the
manner of Li et al. (Science 368:489, 2020): documented cases do not
travel, the undocumented move by a traveller matrix scaled by theta, each
flux out of region q divided by N_q - D_q, every region with a population of
its own. One day of the reference is held to a loop written out here,
sample by sample and region by region, and `counting.py` counts the hooks
that a day calls."""

import sys
import types

import numpy as np
import pytest
import torch

from perfbench import counting
from perfbench import reference as ref

REGIONS = 4
#: the toy's configuration; its arrays are written by `toy`
TOY = {
    "name": "toy", "model": "toy_transport", "regions": REGIONS,
    "mobility": {"file": "travellers.npy"}, "populations": {"file": "populations.npy"},
    "seed_region": 2, "summary": "identity", "distance": "euclidean",
    "theta": [0.5, 0.1, 0.2, 1.0, 1.5],
    "prior_lows": [0.2, 0.05, 0.1, 0.5, 1.0], "prior_highs": [0.9, 0.3, 0.4, 2.0, 2.0],
    "population": 2.1e6, "a0": 40.0, "r0": 1.0, "d0": 5.0, "days": 6, "data_seed": 3,
}


def toy_module(coupled_hook: bool = True) -> types.ModuleType:
    """S, I, D (documented, stays home), R; theta = [beta, alpha, gamma,
    theta, kappa]. Rows 3 and 4 are I's inflow (no source) and outflow (no
    destination). Without `coupled_hook`, I is coupled plainly and the
    inflow reads sum_q M[r, q] * I_q."""
    mod = types.ModuleType("perfbench.models.toy_transport")
    mod.COMPARTMENTS = ("S", "I", "D", "R")
    mod.OBSERVED = ("D",)
    mod.COUPLED = () if coupled_hook else ("I",)
    mod.STOICHIOMETRY = (
        (-1, +1, 0, 0),  # S -> I   beta * S * I / N
        (0, -1, +1, 0),  # I -> D   alpha * I
        (0, -1, 0, +1),  # I -> R   gamma * I
        (0, +1, 0, 0),  # -> I     theta * sum_q M[r, q] * I_q / (N_q - D_q)
        (0, -1, 0, 0),  # I ->     theta * I * out_r / (N_r - D_r)
    )

    def region_constants(mobility, populations):
        """out_q = sum_r M[r, q]: travellers out of region q, rows left to
        right."""
        out = mobility[0]
        for r in range(1, mobility.shape[0]):
            out = out + mobility[r]
        return (out,)

    def hazard_rows(sc, pc, population):
        s, i, d, _r, inflow, out = sc
        beta, alpha, gamma, theta, _kappa = pc
        return (beta * s * i / population, alpha * i, gamma * i, theta * inflow,
                theta * i * out / (population - d))

    def initial_rows(pc, population, a0, r0, d0):
        i0 = pc[4] * a0
        zeros = torch.zeros_like(i0)
        return (population - (i0 + d0 + r0), i0, zeros + d0, zeros + r0)

    mod.region_constants = region_constants
    mod.hazard_rows = hazard_rows
    mod.initial_rows = initial_rows
    if coupled_hook:
        mod.coupled_inputs = lambda sc, populations: (sc[1] / (populations - sc[2]),)
    return mod


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy registered as `perfbench.models.toy_transport`, its
    traveller counts (no self-travel) and populations among the
    configurations' files: (mobility, populations) as float32 arrays."""
    rng = np.random.default_rng(375)
    mob = (rng.random((REGIONS, REGIONS)) * 2e3 * (1 - np.eye(REGIONS))).astype(np.float32)
    pops = rng.uniform(2e5, 8e5, REGIONS).astype(np.float32)
    np.save(tmp_path / "travellers.npy", mob)
    np.save(tmp_path / "populations.npy", pops)
    monkeypatch.setattr(ref, "CONFIGS", tmp_path)
    monkeypatch.setitem(sys.modules, "perfbench.models.toy_transport", toy_module())
    return mob, pops


def hand_initial(theta, cfg, pops):
    """[N, R, 4] of the toy's day 0, one number at a time in float32."""
    f = np.float32
    state = np.zeros((len(theta), REGIONS, 4), np.float32)
    for b, th in enumerate(theta):
        for r in range(REGIONS):
            z = f(1.0 if r == cfg["seed_region"] else 0.0)
            a0, r0, d0 = f(cfg["a0"]) * z, f(cfg["r0"]) * z, f(cfg["d0"]) * z
            i0 = th[4] * a0
            state[b, r] = (pops[r] - ((i0 + d0) + r0), i0, f(0) + d0, f(0) + r0)
    return state


def hand_day(theta, state, mob, pops, z):
    """The next [N, R, 4] state of one day from the normals z [N, R * 5]:
    hazards, counts, the clamps in row order (the inflow's at zero alone)
    and the rows applied in row order, one number at a time in float32."""
    f = np.float32
    zero = f(0)
    out = mob[0]
    for r in range(1, REGIONS):
        out = out + mob[r]
    nxt = np.empty_like(state)
    for b, (beta, alpha, gamma, th, _kappa) in enumerate(theta):
        s, i, d, rc = (state[b, :, k] for k in range(4))
        v = [i[q] / (pops[q] - d[q]) for q in range(REGIONS)]
        for r in range(REGIONS):
            inflow = mob[r, 0] * v[0]
            for q in range(1, REGIONS):
                inflow = inflow + mob[r, q] * v[q]
            h = (beta * s[r] * i[r] / pops[r], alpha * i[r], gamma * i[r], th * inflow,
                 th * i[r] * out[r] / (pops[r] - d[r]))
            n = [np.floor(max(x, zero) + np.sqrt(max(x, zero)) * z[b, r * 5 + k])
                 for k, x in enumerate(h)]
            n0 = min(max(n[0], zero), s[r])
            n1 = min(max(n[1], zero), i[r])
            left = i[r] - n1
            n2 = min(max(n[2], zero), left)
            left = left - n2
            n4 = min(max(n[4], zero), left)
            n3 = max(n[3], zero)
            nxt[b, r] = (s[r] - n0, ((((i[r] + n0) - n1) - n2) + n3) - n4, d[r] + n1,
                         rc[r] + n2)
    return nxt


def test_toy_days_match_a_hand_loop(toy):
    mob, pops = toy
    model = ref.Model(TOY)
    c = model.on("cpu")
    idx = torch.arange(3, 9)
    theta = ref.prior_draw(c, 77, idx)
    lo, hi = torch.tensor(TOY["prior_lows"]), torch.tensor(TOY["prior_highs"])
    assert bool(((theta >= lo) & (theta <= hi)).all())
    th = theta.numpy()
    state = ref.initial_state(c, theta)
    mine = hand_initial(th, TOY, pops)
    assert np.array_equal(state.numpy().view(np.int32), mine.view(np.int32))
    pc = ref.param_rows(c, theta)
    for day in range(4):
        ctr = torch.tensor([(day * model.slots + j) & ref.MASK32
                            for j in range(REGIONS * model.n_trans)])
        z = ref.normal(99, idx[:, None], ctr[None, :]).numpy()
        state, x = ref.day_step(c, state, pc, 99, idx, day)
        nxt = hand_day(th, mine, mob, pops, z)
        assert np.array_equal(state.numpy().view(np.int32), nxt.view(np.int32)), day
        assert np.array_equal(x.numpy(), nxt[:, :, 2])
        mine = nxt
    others = [r for r in range(REGIONS) if r != TOY["seed_region"]]
    assert (mine[:, others, 1] > 0).any(), "the infection never travelled"
    assert (mine >= 0).all()


def test_counting_counts_the_hooks(toy, monkeypatch):
    """The hook's operations are in the counted day: the toy's count less
    that of the same model with I coupled plainly is the hook's subtraction
    and division, one each a region. `region_constants` runs once a run and
    is no sample's work."""
    hooked = counting.counts(TOY)
    monkeypatch.setitem(sys.modules, "perfbench.models.toy_transport",
                        toy_module(coupled_hook=False))
    plain = counting.counts(TOY)
    assert hooked["ops_per_sample_day"] - plain["ops_per_sample_day"] == 2 * REGIONS
    assert hooked["ops_per_sample"] == plain["ops_per_sample"]
