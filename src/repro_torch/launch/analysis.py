"""Op-level analysis of a step: products, bytes, collectives and peak memory
a rank, and the roofline at the card's ceilings (port of
`repro.launch.analysis`).

`repro` reads its three roofline terms from the compiled HLO. PyTorch has
no HLO: `StepCounter` counts the ops the step dispatches, as one rank of
the mesh runs them. It is a `TorchDispatchMode`; an op on DTensors is let
through to DTensor's own dispatch with the counter pushed again, so that
what is counted is each rank's local ops on its shards (and the
collectives DTensor issues), never the global op (counted there, a
`[64, 2048] @ [2048, 16384]` product sharded 64 ways would count 64
times what one rank does). Under `FakeTensorMode` and a fake world
(`launch.dryrun`) nothing is allocated and no device is touched.

  * products: `torch.utils.flop_counter`'s formula for each matrix
    product, attention and convolution op; a Python loop is dispatched, and
    counted, once a trip (`repro` multiplies a while body by its trip
    count for the same reason). With `sample_loops`, the counter puts its
    own `_sampled_blockwise` in `common.blockwise_attention`'s place while
    it runs: serving's blockwise attention (no gradient) then runs one trip
    of its two loops, counted `trips` times (`scaled`): every trip has the
    same shapes and no block is skipped, and a 32k prefill's 4096 block
    pairs a layer would otherwise be dispatched one by one;
  * bytes: the operand and result bytes of every op but views and
    metadata. Eager PyTorch fuses nothing, so this is the traffic the
    step makes; `layout_bytes` reports the part that is copies (`clone`,
    `copy_`, `_to_copy`), included in the total (in `repro` they were
    CPU-lowering artifacts and left out);
  * collectives: each functional collective by kind, its ring wire bytes
    `repro`'s (all-gather rb (n-1)/n, reduce-scatter rb (n-1), all-reduce
    2 rb (n-1)/n, all-to-all rb (n-1)/n, for a result of rb bytes over a
    group of n);
  * peak live bytes: the storages the step's ops make, each counted while
    a tensor holds it, on top of its inputs' local shards.

The roofline divides by the card's ceilings (`repro_torch.device`): bf16
products on the tensor cores, HBM bandwidth, and the link a rank's
collectives cross (`LINK_BYTES_PER_S`). These are counts and bounds on a
fake world, never times measured on a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import device as dev
from repro_torch.models import common as cm

PEAK_FLOPS = dev.BF16_OPS_PER_S  # bf16 dense, tensor cores, per card
HBM_BW = dev.HBM_BYTES_PER_S
LINK_BW = dev.LINK_BYTES_PER_S

#: functional collective op -> kind
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

#: ops that move no data: views, metadata, waits
_NO_BYTES = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "slice", "select",
    "detach", "alias", "as_strided", "unsqueeze", "squeeze", "split", "split_with_sizes",
    "unbind", "chunk", "narrow", "view_as", "expand_as", "unflatten", "flatten", "diagonal",
    "lift_fresh", "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
}
_COPIES = {"clone", "copy_", "_to_copy", "contiguous", "copy"}


def _op_name(func) -> str:
    return func._overloadpacket.__name__.split("::")[-1]


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ring_wire(kind: str, result_bytes: float, n: int):
    """(operand bytes, wire bytes) a rank of a collective of `kind` whose
    result is `result_bytes` over a group of n: `repro`'s ring formulas."""
    rb = float(result_bytes)
    if kind == "all-gather":
        return rb / n, rb * (n - 1) / n
    if kind == "reduce-scatter":
        return rb * n, rb * (n - 1)
    if kind == "all-reduce":
        return rb, 2 * rb * (n - 1) / n
    if kind == "all-to-all":
        return rb, rb * (n - 1) / n
    return rb, rb


def _group_size(func, args) -> int:
    """The group of a functional collective: its group_size argument, else
    the size of the group its name resolves to."""
    schema = func._schema
    for a, v in zip(schema.arguments, args):
        if a.name == "group_size":
            return int(v)
    for a, v in zip(schema.arguments, args):
        if a.name == "group_name":
            from torch.distributed.distributed_c10d import _resolve_process_group

            return _resolve_process_group(v).size()
    return 1


@dataclasses.dataclass
class OpCosts:
    flops: float = 0.0  # products, a rank
    bytes_accessed: float = 0.0  # operand + result bytes, a rank
    layout_bytes: float = 0.0  # the copies among them
    collective_wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_operand: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    ops: int = 0
    argument_bytes: int = 0  # the step's inputs, this rank's shards
    live_bytes: int = 0
    peak_bytes: int = 0

    @property
    def total_wire(self) -> float:
        return sum(self.collective_wire.values())

    @property
    def total_operand(self) -> float:
        return sum(self.collective_operand.values())


class StepCounter(TorchDispatchMode):
    """Counts what one rank does while it is active (see the module
    docstring). `track_inputs` first registers the step's arguments, whose
    local shards are live from the start."""

    def __init__(self, sample_loops: bool = False):
        super().__init__()
        self.costs = OpCosts()
        self._refs: Dict[int, list] = {}
        self._paused = 0
        self._weight = 1
        self.sample_loops = sample_loops

    @contextlib.contextmanager
    def scaled(self, trips: int):
        """Count the block's ops `trips` times (a loop run for one trip of
        `trips` alike: `repro`'s while-loop trip multiplier)."""
        self._weight *= trips
        try:
            yield
        finally:
            self._weight //= trips

    # --- live storages
    def _hold(self, t: torch.Tensor):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [0, int(st.nbytes())]
            self.costs.live_bytes += entry[1]
            self.costs.peak_bytes = max(self.costs.peak_bytes, self.costs.live_bytes)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.costs.live_bytes -= entry[1]
            del self._refs[key]

    def track_inputs(self, *trees):
        from torch.distributed.tensor import DTensor

        for t in _tensors(trees):
            loc = t._local_tensor if isinstance(t, DTensor) else t
            before = self.costs.live_bytes
            self._hold(loc)
            self.costs.argument_bytes += self.costs.live_bytes - before

    # --- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch runs the local ops, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    # DTensor infers each result's global shape by running the op on fake
    # tensors of the global shapes: not work a rank does, so not counted
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        counter, infer = self, ShardingPropagator._propagate_tensor_meta_non_cached

        def paused(prop, op_schema):
            counter._paused += 1
            try:
                return infer(prop, op_schema)
            finally:
                counter._paused -= 1

        self._infer = infer
        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        self._plain_blockwise = cm.blockwise_attention
        if self.sample_loops:
            cm.blockwise_attention = self._sampled_blockwise
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._infer
        cm.blockwise_attention = self._plain_blockwise
        return super().__exit__(*exc)

    def _sampled_blockwise(self, q, k, v, **kw):
        """`common.blockwise_attention` while a `sample_loops` counter runs:
        with no gradient to take (serving), one trip of each of its two
        loops, counted as all of them (every trip has the same shapes and
        work: no block is skipped); the other q blocks' outputs are left
        unwritten, so the result is for counting only."""
        if torch.is_grad_enabled():
            return self._plain_blockwise(q, k, v, **kw)
        blocks = cm.Blockwise(q, k, v, **kw)
        with self.scaled(len(blocks.q_starts)):
            state = blocks.start(0)
            with self.scaled(len(blocks.kv_starts)):
                state = blocks.kv_step(state, 0)
            first = blocks.end(state)
        return blocks.finish([first] + [torch.empty_like(first) for _ in blocks.q_starts[1:]])

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        c, w = self.costs, self._weight
        c.ops += w
        name = _op_name(func)
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if func.namespace in ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional"):
            kind = _COLL_OPS.get(name)
            if kind is not None:
                n = max(_group_size(func, args), 1)
                operand, wire = ring_wire(kind, sum(_nbytes(t) for t in outs), n)
                c.collective_wire[kind] = c.collective_wire.get(kind, 0.0) + wire * w
                c.collective_operand[kind] = c.collective_operand.get(kind, 0.0) + operand * w
                c.collective_counts[kind] = c.collective_counts.get(kind, 0) + w
        flop_fn = flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out)) * w
            c.flops += f
            c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + f
        if name in _NO_BYTES or func.namespace == "prim":
            return
        b = (sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)) * w
        c.bytes_accessed += b
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + b
        if name in _COPIES:
            c.layout_bytes += b


# ----------------------------------------------------------------- roofline
@dataclasses.dataclass
class Roofline:
    flops: float  # products a rank (each loop trip counted)
    bytes_accessed: float  # operand + result bytes a rank
    collective_wire: float
    collective_operand: float
    collective_detail: Dict[str, float]
    n_devices: int
    model_flops: float  # analytic global model flops for this step
    raw_cost_analysis: Dict[str, float]
    layout_bytes: float = 0.0  # the copies in bytes_accessed (reported, included)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_wire / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / (counted products x devices): remat and redundancy
        waste."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flop utilization if the step ran exactly at the dominant
        roofline term."""
        denom = self.t_bound * self.n_devices * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_wire_bytes": self.collective_wire,
            "collective_operand_bytes": self.collective_operand,
            "collective_detail": self.collective_detail,
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "raw_cost_analysis": self.raw_cost_analysis,
            "layout_bytes": self.layout_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_step_flops(model, shape) -> float:
    """6*N*D (train) / 2*N*D (inference), N = active params."""
    n = model.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline_from_costs(costs: OpCosts, model, shape, n_devices: int) -> Roofline:
    return Roofline(
        flops=costs.flops,
        bytes_accessed=costs.bytes_accessed,
        collective_wire=costs.total_wire,
        collective_operand=costs.total_operand,
        collective_detail=dict(costs.collective_wire),
        n_devices=n_devices,
        model_flops=model_step_flops(model, shape),
        raw_cost_analysis={"flops": costs.flops, "bytes_accessed": costs.bytes_accessed,
                           "ops": float(costs.ops)},
        layout_bytes=costs.layout_bytes,
    )
