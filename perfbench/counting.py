"""The benchmark's own count of the arithmetic a sample needs, from its
reference (`perfbench/reference.py`), whatever implements the kernel.

One simulated day of the reference, and one prior draw with the final
distance, run eagerly under a dispatch mode that counts one operation an
output element of each elementwise arithmetic, math, comparison, bitwise,
select or clamp operation. Reductions, views, copies, casts and factories
count nothing. The reference keeps its 32-bit hash words in int64, so a
`& MASK32` on an integer tensor (it only emulates uint32 wraparound) is
free, and `_mul32` (seven int64 operations for one uint32 multiply) counts
as one multiply an element. A transcendental counts as one operation.
A model file's hooks count where the day calls them: `coupled_inputs` and
`hazard_rows` with the day; `region_constants`, worked out once a run when
the reference's constants are made, is no sample's work and counts nothing.

The counts are data in each configuration file (`ops_per_sample_day`,
`ops_per_sample`); `test_perfbench_reference.py` holds the files to this
function, and `python3 perfbench/counting.py <config>` prints them.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COUNTED = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg", "sign", "sgn", "abs",
    "maximum", "minimum", "pow", "sqrt", "rsqrt", "reciprocal", "square",
    "log", "log1p", "exp", "expm1", "tanh", "sigmoid", "erf", "erfinv",
    "floor", "ceil", "round", "trunc", "nextafter",
    "sin", "cos", "atan2", "isnan",
    "eq", "ne", "lt", "le", "gt", "ge",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "__and__", "__or__", "__xor__",
    "__lshift__", "__rshift__", "__ilshift__", "__irshift__",
    "bitwise_left_shift", "bitwise_right_shift",
    "where", "clamp", "clamp_min", "clamp_max",
})
#: rows of the counted day: large enough that per-call scalars vanish
ROWS = 256


def _name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.inside = 0

    @contextlib.contextmanager
    def word_op(self):
        self.inside += 1
        try:
            yield
        finally:
            self.inside -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from perfbench.reference import MASK32

        out = func(*args, **(kwargs or {}))
        name = _name(func)
        if self.inside or name not in COUNTED:
            return out
        if (name in ("bitwise_and", "__and__") and len(args) == 2
                and isinstance(args[0], torch.Tensor) and not args[0].is_floating_point()
                and isinstance(args[1], int) and args[1] == MASK32):
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.total += float(max((o.numel() for o in outs if isinstance(o, torch.Tensor)),
                                default=1))
        return out


def count_ops(fn, *args) -> float:
    """Operations of `fn(*args)`, one an output element."""
    from perfbench import reference

    counter = _Counter()
    plain = reference._mul32

    def mul32(x, m):
        if not isinstance(x, torch.Tensor):
            return plain(x, m)
        with counter.word_op():
            out = plain(x, m)
        counter.total += float(out.numel())
        return out

    with mock.patch.object(reference, "_mul32", mul32), counter:
        fn(*args)
    return counter.total


def counts(cfg: dict) -> dict:
    """{"ops_per_sample_day", "ops_per_sample"} of a configuration: one
    day's step and running distance, and a sample's prior draw and final
    distance, each over `ROWS` rows."""
    from perfbench import reference as ref

    m = ref.Model(cfg)
    c = m.on("cpu")
    theta = torch.zeros((ROWS, m.n_params))
    state = ref.initial_state(c, theta)
    pc = ref.param_rows(c, theta)
    idx = torch.arange(ROWS)
    seed = torch.zeros((ROWS, 1), dtype=torch.int64)
    binv = torch.zeros((ROWS, m.n_chan))
    acc = torch.zeros((ROWS,))
    obs_t = torch.zeros((m.n_chan,))

    def day():
        st, x = ref.day_step(c, state, pc, seed, idx, 1)
        ref.running_day(c, x, obs_t, binv, acc)

    def sample():
        ref.prior_draw(c, seed, idx)
        ref.finalize(acc)

    return {"ops_per_sample_day": count_ops(day) / ROWS,
            "ops_per_sample": count_ops(sample) / ROWS}


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here.parent))
    for name in sys.argv[1:]:
        print(name, json.dumps(counts(json.loads((here / "configs" / f"{name}.json").read_text()))))
