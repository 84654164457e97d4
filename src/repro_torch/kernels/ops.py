"""User-facing kernels, dispatched by device: the fused simulate-and-distance
and flash attention.

Counterpart of `repro.kernels.ops.abc_sim_distance`: it lowers the
(summary, distance) pair against the observed series, lays theta out as
structure of arrays, packs the constants and launches the CUDA kernel.
`make_abc_sim` does the lowering and packing once for a fixed series, so
that each later call only lays out theta and sets the seed. Its `wave`
draws theta from a uniform box prior and simulates it in one launch of the
kernel's wave entry: the ABC main path. Under an intervention schedule theta
carries the schedule's scale columns, and its breakpoints and scaled
parameters are packed beside the summary flags.

A regional model (`model.is_regional`) runs the kernel's region axis. Its
mobility matrix (the spec's, or a `mobility=` override, checked as the spec
checks its own) and its channel weights go to device buffers once, when
`make_abc_sim` makes the simulator, and no wave copies them again; the
matrix is a run-time value of the kernel, so a mobility sweep reuses one
build. `region_pooled` pools the regions' channels (`pool`). Every
regional simulator also gets the tile route's buffers once
(`abc_sim.tile_buffers`: the matrix transposed and padded, the region
populations, the spec's region constants), so that each route can launch
from it.

On the card every call goes through an `abc_sim.Launch`, made by
`abc_sim.launch` the first time the simulator calls an entry at a batch
and kept: the route, the C function and the fixed buffers are decided and
checked once, and each later call hands it only seeds, theta or the box,
the gate, the output buffers and the offset.

Dispatch is by device: a CPU tensor goes to the plain PyTorch version
(`repro_torch.kernels.ref`); a CUDA tensor goes to the kernel, or raises.
Nothing falls back from the card to the plain version.

Both calls of `AbcSim` take a `gate`: None, or an int32 tensor of shape [1]
on the simulator's device. Where it reads 0 the call writes nothing: on the
card the kernel reads it when it runs, so a loop can enqueue calls without
waiting; on the CPU the gate is a CPU tensor and a gate of 0 skips the
plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.priors import UniformBoxPrior
from repro_torch.core.summaries import get_summary, lower_summary, pool_factor
from repro_torch.epi.engine import check_theta_width, mobility_matrix
from repro_torch.epi.spec import CompartmentalModel, active_schedule, validate_mobility
from repro_torch.kernels import abc_sim, ref
from repro_torch.kernels import flash_attention as fa


class AbcSim:
    """The fused simulate-and-distance against one observed series, on that
    series' device. Made by `make_abc_sim`.

    `sim(theta [B, W], seed) -> distances [B]`, W the model's parameters plus
    the schedule's scale columns; theta must lie on the series' device.
    `sim.wave(prior, prior_seed, sim_seed, batch)` is one ABC wave: theta
    drawn by `prior.sample(prior_seed, batch)` and its distances with NaN
    turned to +inf. On a CUDA device with a `UniformBoxPrior` that is one
    launch of the kernel's wave entry, which draws theta itself (no
    host-side prior draw); on the CPU it is `prior.sample` followed by the
    plain version. `wave` writes into `out=(theta, dist)` when given, and
    at `offset=o` draws the samples at indices o .. o + batch - 1 of the
    hash (`rng.sample_indices`): rows [o, o + batch) of the wave of o + batch
    at offset 0. Under a `gate` that reads 0 neither call writes anything:
    the distances of `sim(...)` and a new wave's tensors are then left
    unwritten.
    """

    def __init__(self, observed: torch.Tensor, *, population: float, a0: float,
                 r0: float, d0: float, model: CompartmentalModel, spec, distance: str,
                 block: Optional[int], schedule=None, mobility=None,
                 mob: Optional[torch.Tensor] = None):
        self.observed, self.model, self.spec, self.distance = observed, model, spec, distance
        self.scalars = dict(population=population, a0=a0, r0=r0, d0=d0)
        self.block = block
        self.schedule = active_schedule(schedule)
        self.width = (model.n_params if self.schedule is None
                      else self.schedule.param_width(model))
        self.mobility = mobility
        self.pool = pool_factor(spec, model.n_regions)
        self.device = observed.device
        # the region axis's device buffers and the tile route's
        # (`abc_sim.tile_buffers`); the launches made so far, by (entry,
        # batch, route)
        self.weights = self.mob = self.tile = None
        self._launches: dict = {}
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"observed must be on the CPU or a CUDA device, got {self.device}")
        if observed.ndim != 2 or observed.shape[0] != model.total_observed:
            raise ValueError(f"observed must be [{model.total_observed}, T] for {model.name}, "
                             f"got {tuple(observed.shape)}")
        if self.device.type == "cuda":
            lowered = lower_summary(spec, distance, observed, n_regions=model.n_regions)
            self.obs_summary = lowered.obs_summary.contiguous()
            weights = lowered.weights
            if model.is_regional:
                # device buffers of the region axis, made once a simulator
                self.weights = weights.contiguous()
                if mob is None and model.coupled:
                    mob = mobility_matrix(model, mobility, self.device).contiguous()
                self.mob = mob if model.coupled else None
                abc_sim.check_regional(model, self.obs_summary, self.mob, self.weights,
                                       self.pool, None, block)
                self.tile = abc_sim.tile_buffers(model, self.mob, population, self.device)
                weights = torch.zeros((0,))
            self.fconst, self.iconst = abc_sim.pack_consts(
                mean_scale=lowered.mean_scale, weights=weights.cpu().numpy(),
                flags=lowered.flags, seed=0, model=model, schedule=self.schedule,
                **self.scalars,
            )

    def entry(self, entry: str, batch: int) -> str:
        """The C name of the kernel entry ("wave" or "distance") that a call
        of `batch` samples launches on the card."""
        route = abc_sim.regional_route(self.model, batch) if self.model.is_regional else None
        return abc_sim.entry_name(self.model, entry, route)

    def launch(self, entry: str, batch: int, route: Optional[str] = None) -> abc_sim.Launch:
        """The `abc_sim.Launch` of `entry` at `batch` samples on the card,
        made the first time it is asked for and kept; `route` holds one of
        the region axis's routes against another (None: `regional_route`'s)."""
        key = (entry, int(batch), route)
        made = self._launches.get(key)
        if made is None:
            if self.device.type != "cuda":
                raise ValueError(f"a kernel launch runs on a CUDA device; this simulator is on "
                                 f"{self.device}")
            made = self._launches[key] = abc_sim.launch(
                self.model, entry, batch, obs=self.obs_summary, fconst=self.fconst,
                iconst=self.iconst, weights=self.weights, mobility=self.mob, tile=self.tile,
                pool=self.pool, block=self.block, route=route)
        return made

    def record_gated(self, entry: str, batch: int, n: int) -> None:
        """Record `n` launches of `entry` at `batch` whose gate read 0
        (`abc_sim.record_gated`); on the CPU nothing launched."""
        if self.device.type == "cuda":
            abc_sim.record_gated(self.entry(entry, batch), n)

    def _gated_off(self, gate: Optional[torch.Tensor]) -> bool:
        """On the CPU: whether `gate` (checked) reads 0."""
        abc_sim.check_gate(gate, self.device)
        return gate is not None and int(gate[0]) == 0

    def __call__(self, theta: torch.Tensor, seed: int,
                 gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        model = self.model
        check_theta_width(model, self.schedule, theta)
        if theta.device != self.device:
            raise ValueError(f"theta is on {theta.device}, the observed series on "
                             f"{self.device}")
        if self.device.type == "cuda":
            return self.launch("distance", theta.shape[0])(seed, abc_sim.theta_to_soa(theta),
                                                           gate=gate)
        if self._gated_off(gate):
            return torch.empty((theta.shape[0],), dtype=torch.float32)
        return self._plain(theta, seed)

    def _plain(self, theta: torch.Tensor, seed: int, offset: int = 0) -> torch.Tensor:
        """The plain version's distances of a CPU theta, its samples hashed
        from index `offset` on."""
        return ref.abc_sim_distance_ref(
            theta, seed, self.observed, model=self.model, summary=self.spec,
            distance=self.distance, schedule=self.schedule, mobility=self.mobility,
            sample_offset=offset, **self.scalars,
        )

    def wave(self, prior, prior_seed: int, sim_seed: int, batch: int,
             gate: Optional[torch.Tensor] = None,
             out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             offset: int = 0,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(theta [batch, W], distances [batch] with NaN as +inf) of the
        samples at hash indices offset .. offset + batch - 1, in `out` when
        it is given."""
        if prior.dim != self.width:
            what = "" if self.schedule is None else " and scale columns"
            raise ValueError(f"the prior has {prior.dim} dimensions; {self.model.name} has "
                             f"{self.width} parameters{what}")
        if self.device.type == "cuda":
            if isinstance(prior, UniformBoxPrior):
                return self.launch("wave", batch)(sim_seed, prior_seed, prior.lows, prior.highs,
                                                  gate=gate, out=out, offset=offset)
            if gate is not None or offset:
                raise ValueError("a gated or offset wave on the card draws theta in the "
                                 f"kernel: it needs a UniformBoxPrior, got "
                                 f"{type(prior).__name__}")
        elif self._gated_off(gate):
            return abc_sim.wave_out(out, batch, self.width, self.device)
        theta = prior.sample(prior_seed, batch, self.device, offset=offset)
        dist = (self._plain(theta, sim_seed, offset) if self.device.type == "cpu"
                else self(theta, sim_seed))
        # failed (NaN) simulations never count as accepted
        dist = torch.where(torch.isnan(dist), torch.full_like(dist, float("inf")), dist)
        if out is None:
            return theta, dist
        th_out, d_out = abc_sim.wave_out(out, batch, self.width, self.device)
        th_out.copy_(theta)
        d_out.copy_(dist)
        return th_out, d_out


def check_mobility(model: CompartmentalModel, mobility):
    """A mobility override as nested float tuples, checked against the
    model: only a regional model takes one, [R][R] and row-stochastic (or
    traveller counts, for a spec of `mobility_counts`). None passes through
    (the spec's own matrix)."""
    if mobility is None:
        return None
    if not model.is_regional:
        raise ValueError(f"mobility set but model {model.name!r} has no region axis")
    return validate_mobility(mobility, model.n_regions, model.mobility_counts)


def make_abc_sim(
    observed: torch.Tensor,  # [total_observed, T] f32
    *,
    population: float,
    a0: float,
    r0: float = 0.0,
    d0: float = 0.0,
    model: CompartmentalModel | None = None,
    summary=None,  # SummarySpec / registry name / None (identity)
    distance: str = "euclidean",
    schedule=None,
    block: Optional[int] = None,  # threads; None: the kernel's own default
    mobility=None,  # [R][R] override of a regional model's matrix
    mob: Optional[torch.Tensor] = None,
) -> AbcSim:
    """The fused simulate-and-distance against `observed`, on `observed`'s
    device (`AbcSim`), under an intervention `schedule` if one is given (an
    empty schedule is None) and, for a regional model, a `mobility`
    override if one is given. `mob` is the `.mob` buffer of another
    simulator of the same model and mobility on the same card, shared in
    place of a new copy of the matrix."""
    if model is None:
        from repro_torch.epi.models import DEFAULT_MODEL as model  # noqa: N811
    schedule = active_schedule(schedule)
    if schedule is not None:
        schedule.shape(model)  # its parameters are the model's
    return AbcSim(observed.to(torch.float32), population=population, a0=a0, r0=r0, d0=d0,
                  model=model, spec=get_summary(summary), distance=distance, block=block,
                  schedule=schedule, mobility=check_mobility(model, mobility), mob=mob)


def abc_sim_distance(
    theta: torch.Tensor,  # [B, n_params (+ n_scales)] f32
    seed: int,  # uint32
    observed: torch.Tensor,  # [n_observed, T] f32
    **kwargs,
) -> torch.Tensor:
    """Fused simulate + summary distance for a batch of samples. Returns [B]
    on theta's device; `kwargs` are those of `make_abc_sim`."""
    return make_abc_sim(observed.to(theta.device), **kwargs)(theta, seed)


class FlashBackwardError(RuntimeError):
    """A gradient was asked of the flash route, which has none."""


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D] (model layout)
    k: torch.Tensor,  # [B, T, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward flash attention in the model layout; returns [B, S, H, D] in
    q's dtype. Counterpart of `repro.kernels.ops.flash_attention`: the CUDA
    kernels read the model layout through its strides and mask ragged
    lengths themselves, so nothing is transposed or padded here. A CPU q
    goes to `ref.flash_attention_ref`, a CUDA q to the kernel of its dtype
    (`flash_attention.route`: bf16 on the tensor cores, float32 on the CUDA
    cores), which raises on tensors it does not take.

    Neither the kernels nor `repro`'s TPU kernel have a backward: a call
    that autograd would have to differentiate (grad mode on and q, k or v
    requiring a gradient) raises `FlashBackwardError` on every device,
    rather than train on the CPU's plain version and drop the gradients of
    q, k and v on the card. Training takes attn_impl "dense" or
    "blockwise", as `repro`'s does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise FlashBackwardError(
            "the flash route has no backward (neither the CUDA kernels nor repro's "
            "TPU kernel); a loss that needs gradients takes attn_impl='dense' or "
            "'blockwise'")
    if q.device.type == "cpu":
        for name, t in (("k", k), ("v", v)):
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"q must be on the CPU or a CUDA device, got {q.device}")
    return fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
