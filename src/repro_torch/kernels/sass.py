"""Instruction census of a kernel's day loop from `cuobjdump -sass`.

What bounds the fused ABC kernel (`csrc/abc_sim.cuh`) is how many
instructions the card must issue for one sample-day, not bytes. This module
reads a `cuobjdump -sass` listing and counts the instructions of the path
one day takes through the body of the day loop, by class:

    fp32     FADD, FMUL, FFMA, FSETP, FMNMX, FSEL, ... (128 a clock an SM)
    int_mul  IMAD in all its forms, IMUL           (64)
    int_alu  IADD3, LOP3, SHF, ISETP, LEA, SEL, ... (64)
    quarter  MUFU.*, I2F, I2FP, F2I, FRND, F2F      (16)
    branch   BRA, BSSY, BSYNC, CALL, EXIT, ...      (issue slots only)
    memory   LDS, LDG, STG, LDC, ULDC, LDL, ...     (issue slots only)
    other    S2R, CS2R, uniform ops, NOP, ...       (issue slots only)

The day loop is the backward branch of the function that spans the most
instructions; where that loop holds another backward branch that spans at
least half as many, the inner one, and so on down (the kernel runs its days
as segments between an intervention schedule's breakpoints: the segment
loop holds the day loop and little else). The path through its body starts
at the branch's target and
ends at the branch. At each conditional forward branch it takes the side
that a day at these arguments takes, by these rules, in order:

1. the code the branch skips holds a cold block (a CALL to an out-of-line
   slow path, local memory: LDL/STL, float64, or an inner loop): the
   branch is taken. These are the Payne-Hanek reduction of cosf behind its
   32-byte stack and the out-of-line denormal fix-ups of IEEE division and
   sqrtf;
2. the code at the target, up to its first branch or join (BSYNC), holds
   a cold block: the branch falls through;
3. the skipped code ends in an unconditional branch (an if/else whose
   first arm falls through, as powf lays out its special cases around the
   general case): the branch falls through;
4. otherwise (an `if (rare) fix-up` with no else, such as log1pf's
   treatment of infinity): the branch is taken.

Every conditional branch is reported with its rule and the instructions it
skips, so a reader can check each decision. Predicated instructions count
whatever their predicate: they take an issue slot either way.

The issue floor of a launch is the larger of the issue limit (4
warp-instructions a clock an SM) and each class's own pipe limit:

    cycles per sample-day = max(total / 128, fp32 / 128, int_mul / 64,
                                int_alu / 64, quarter / 16)
    floor ms = cycles * (samples * days) / (SMs * clock)

with per-sample work outside the loop added once per sample.

The regional kernel (`csrc/abc_sim_regional.cuh`) runs loops over the
regions inside its day loop, none of them unrolled. `regional_census`
counts each loop's own instructions (its path, less the loops inside it)
and gives each its trips a sample-day: the day loop's own code once, the
coupled rows' loop R times and its inner sum R * (R - 1) times (coupled
models), the region loop R times and the summary loop once a row of
channels (R rows, or one pooled). The day loop is the segment loop's
largest inner loop; among the loops inside it, the region loop is the one
with the most quarter-rate instructions (the normals' MUFU), the coupled rows' loop
the one before it that holds a loop (nvcc also keeps a copy without the
inner sum for R = 1, not counted), and the summary loop one after it: nvcc
keeps a copy for pooled channels, which reads fewer words of local memory
than the unpooled copy. A function of another shape is reported, with no
floor.

The warp route of the region axis (`csrc/abc_sim_regional_warp.cuh`) runs
one sample on a warp, so its census counts warp-instructions a sample-day:
`regional_warp_census` finds, inside the day loop, the coupled rows' loops
over groups of four sources (one for each NR = 1..4 regions a lane, told
apart by their FMULs, ceil(R / 4) trips), the pooled sums' loop (R - 1
trips) and the channel chain's loop (the one with 16-byte shared loads,
ceil(n_chan / 8) trips), and the region passes 1-3: the code after each
conditional branch whose skipped code holds the normals' MUFU.RSQ, up to
the next such branch (pass 3: up to its target). The walk falls through these branches (every pass runs) and
takes the branch between the pooled sums and the chain that the launch
takes; a pass a lane does not need (i >= ceil(R / 32)) is then taken out
again, with its guard. `regional_warp_issue_floor_ms` counts a
warp-instruction as one issue slot for one sample.

The tile route of the region axis (`csrc/abc_sim_regional_tile.cuh`) runs
a city of a sample a thread in its region pass (step 2), a loop over the
thread's cities with the normals inside. `tile_region_census` finds it as
the loop whose own code (less the loops inside it, such as cosf's
Payne-Hanek reduction) holds the most quarter-rate instructions, and
counts one trip of its path: the instructions a city-sample-day.
`tile_region_floor_ms` gives the least time the card needs to issue the
region passes of a launch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: thread-instructions a clock an SM, per class, for compute capability 9.0
RATES = {"issue": 128, "fp32": 128, "int_mul": 64, "int_alu": 64, "quarter": 16}
CLASSES = ("fp32", "int_mul", "int_alu", "quarter", "branch", "memory", "other")

_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET", "FCHK", "FSWZADD",
         "FADD32I", "FMUL32I", "FFMA32I", "HFMA2", "HADD2", "HMUL2", "FCMP"}
_INT_MUL = {"IMAD", "IMUL", "IMAD32I", "IMUL32I", "IDP", "IMADSP"}
_INT_ALU = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR",
            "ISETP", "ISET", "IMNMX", "VIMNMX", "IABS", "LEA", "VIADD", "VIADDMNMX", "SEL",
            "PRMT", "POPC", "FLO", "BREV", "BMSK", "MOV", "MOV32I", "P2R", "R2P", "PLOP3",
            "ICMP", "IMNMX3", "SGXT"}
_QUARTER = {"MUFU", "I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F"}
_BRANCH = {"BRA", "BRX", "JMP", "JMX", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
           "BAR", "BPT", "KILL", "YIELD", "BMOV", "BREAK", "NANOSLEEP"}
_MEMORY = {"LD", "ST", "LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "ULDC", "LDSM",
           "ATOM", "ATOMS", "ATOMG", "RED", "LDGSTS", "LDGDEPBAR", "CCTL", "MEMBAR",
           "SYNCS", "UBLKCP", "UTMALDG", "UTMASTG"}
#: opcodes whose presence makes a block cold: slow paths never taken here
_COLD = {"CALL", "LDL", "STL", "DMUL", "DADD", "DFMA", "DSETP"}


def opcode_class(opcode: str) -> str:
    """The class of one SASS opcode, with or without its modifiers."""
    base = opcode.split(".")[0]
    if base in _FP32:
        return "fp32"
    if base in _INT_MUL:
        return "int_mul"
    if base in _INT_ALU:
        return "int_alu"
    if base in _QUARTER:
        return "quarter"
    if base in _BRANCH:
        return "branch"
    if base in _MEMORY:
        return "memory"
    return "other"


@dataclasses.dataclass(frozen=True)
class Instr:
    addr: int
    pred: str  # "" or e.g. "@!P0"
    opcode: str  # with modifiers, e.g. "FSETP.GEU.AND"
    operands: str

    @property
    def base(self) -> str:
        return self.opcode.split(".")[0]

    @property
    def target(self) -> Optional[int]:
        """The address a branch or call goes to, where it names one."""
        m = re.search(r"0x([0-9a-f]+)", self.operands)
        return int(m.group(1), 16) if m and self.base in ("BRA", "CALL", "BSSY") else None

    def __str__(self) -> str:
        return f"/*{self.addr:04x}*/ {self.pred + ' ' if self.pred else ''}{self.opcode} " \
               f"{self.operands}".rstrip()


_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def parse_functions(sass: str) -> Dict[str, List[Instr]]:
    """The instructions of each function of a `cuobjdump -sass` (or
    `nvdisasm`) listing, under the function's mangled name. Branch targets
    written as labels (`(.L_x_3)`) become addresses."""
    funcs: Dict[str, List[Instr]] = {}
    labels: Dict[str, Dict[str, int]] = {}
    pending: List[str] = []
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line) or re.match(r"^\s*\.text\.(\S+):", line)
        if m:
            current = m.group(1)
            funcs[current], labels[current], pending = [], {}, []
            continue
        if current is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _LINE.search(line)
        if m:
            ins = Instr(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                        m.group(4).strip())
            for name in pending:
                labels[current][name] = ins.addr
            pending = []
            funcs[current].append(ins)
    for name, body in funcs.items():
        table = labels[name]
        if table:
            funcs[name] = [dataclasses.replace(i, operands=re.sub(
                r"`?\((\.L_x_\d+)\)", lambda m: hex(table[m.group(1)]), i.operands))
                for i in body]
    return funcs


def _is_uncond_branch(i: Instr) -> bool:
    return i.base == "BRA" and not i.pred


def _cold(code: Sequence[Instr]) -> bool:
    """A slow path: a call, local memory, float64, or a loop inside `code`."""
    start = code[0].addr if code else 0
    return any(i.base in _COLD or (i.base == "BRA" and i.target is not None
                                   and start <= i.target < i.addr) for i in code)


def day_loop(body: List[Instr]) -> Tuple[int, int]:
    """(index of the loop head, index of its backward branch): the backward
    branch that spans the most instructions, or the largest loop inside it
    that spans at least half of it, repeated."""
    index = {i.addr: n for n, i in enumerate(body)}
    loops = [(index[i.target], n) for n, i in enumerate(body)
             if i.base == "BRA" and i.target is not None and i.target < i.addr
             and i.target in index]
    if not loops:
        raise ValueError("no loop (backward branch) in this function")

    def span(loop):
        return loop[1] - loop[0]

    best = max(loops, key=span)
    while True:
        inner = [lp for lp in loops if lp != best and best[0] <= lp[0] and lp[1] <= best[1]]
        big = max(inner, key=span, default=None)
        if big is None or 2 * span(big) < span(best):
            return best
        best = big


def _block_at(body: List[Instr], start: int) -> List[Instr]:
    """The code from `start` up to its first branch, join (BSYNC) or exit."""
    out = []
    for i in body[start:]:
        out.append(i)
        if i.base in ("BRA", "BSYNC", "EXIT"):
            break
    return out


def decide(body: List[Instr], index: Dict[int, int], n: int) -> Tuple[bool, int, int]:
    """(taken, rule, instructions skipped when taken) of the conditional
    forward branch body[n], by the rules of the module docstring."""
    br = body[n]
    t = index[br.target]
    skipped = body[n + 1:t]
    if _cold(skipped):
        return True, 1, len(skipped)
    if _cold(_block_at(body, t)):
        return False, 2, len(skipped)
    if any(_is_uncond_branch(i) for i in skipped):
        return False, 3, len(skipped)
    return True, 4, len(skipped)


def walk(body: List[Instr], start: int, stop: int,
         branches: Optional[list] = None, force: Optional[Dict[int, bool]] = None) -> List[Instr]:
    """The instructions from body[start] to body[stop] along the path the
    rules choose (`force` maps a branch's index to taken or not, in place
    of the rules). A backward branch other than `stop` is left (its loop
    runs once); a conditional exit falls through."""
    index = {i.addr: n for n, i in enumerate(body)}
    path, n, seen = [], start, set()
    while True:
        if n in seen:
            raise ValueError(f"the walk came back to {body[n]}")
        seen.add(n)
        ins = body[n]
        path.append(ins)
        if n == stop:
            return path
        if ins.base == "EXIT" and not ins.pred:
            return path
        t = ins.target
        if ins.base == "BRA" and t is not None and t > ins.addr:
            if not ins.pred:
                n = index[t]
                continue
            taken, rule, skipped = decide(body, index, n)
            if force is not None and n in force:
                taken, rule = force[n], 0
            if branches is not None:
                branches.append({"at": f"{ins.addr:04x}", "branch": str(ins).split("*/ ")[1],
                                 "taken": taken, "rule": rule, "skips": skipped})
            n = index[t] if taken else n + 1
            continue
        n += 1


def count(path: Sequence[Instr]) -> Dict[str, int]:
    out = {c: 0 for c in CLASSES}
    for i in path:
        out[opcode_class(i.opcode)] += 1
    out["total"] = len(path)
    return out


def census(body: List[Instr]) -> dict:
    """Per-day instruction counts of the day loop of one function, and the
    per-sample ones of the code around it."""
    head, back = day_loop(body)
    branches: list = []
    loop = walk(body, head, back, branches)
    whole = walk(body, 0, len(body) - 1)
    outside = [i for i in whole if not body[head].addr <= i.addr <= body[back].addr]
    quarter = {}
    for i in loop:
        if opcode_class(i.opcode) == "quarter":
            quarter[i.opcode] = quarter.get(i.opcode, 0) + 1
    return {"per_day": count(loop), "per_sample_outside_loop": count(outside),
            "loop_span": [f"{body[head].addr:04x}", f"{body[back].addr:04x}"],
            "loop_span_instructions": back - head + 1,
            "quarter_rate_opcodes": dict(sorted(quarter.items())),
            "conditional_branches": branches}


def cycles_per_sample_day(per_day: Dict[str, int]) -> Tuple[float, str]:
    """(SM cycles a sample-day at full rate, the limit that sets it)."""
    limits = {"issue": per_day["total"] / RATES["issue"]}
    for c in ("fp32", "int_mul", "int_alu", "quarter"):
        limits[c] = per_day[c] / RATES[c]
    which = max(limits, key=limits.get)
    return limits[which], which


def issue_floor_ms(result: dict, batch: int, days: int, n_sm: int, clock_mhz: float) -> dict:
    """The least time the card needs to issue one launch's instructions."""
    day_cycles, by = cycles_per_sample_day(result["per_day"])
    sample_cycles, _ = cycles_per_sample_day(result["per_sample_outside_loop"])
    cycles = batch * (days * day_cycles + sample_cycles) / n_sm
    return {"floor_ms": cycles / (clock_mhz * 1e6) * 1e3, "bound_by": by,
            "cycles_per_sample_day": day_cycles, "sm_clock_mhz": clock_mhz, "sms": n_sm,
            "instructions_per_sample_day": result["per_day"]["total"]
            + result["per_sample_outside_loop"]["total"] / days}


def _loops(body: List[Instr]) -> List[Tuple[int, int]]:
    index = {i.addr: n for n, i in enumerate(body)}
    return [(index[i.target], n) for n, i in enumerate(body)
            if i.base == "BRA" and i.target is not None and i.target < i.addr
            and i.target in index]


def _children(loop: Tuple[int, int], loops: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The loops directly inside `loop`, in address order."""
    inner = [lp for lp in loops if lp != loop and loop[0] <= lp[0] and lp[1] <= loop[1]]
    return sorted(lp for lp in inner
                  if not any(o != lp and o[0] <= lp[0] and lp[1] <= o[1] for o in inner))


def _own(body: List[Instr], loop: Tuple[int, int], inner: Sequence[Tuple[int, int]]) -> dict:
    """Counts of one pass of `loop`'s path, less the loops inside it."""
    return count(_own_path(body, loop, inner))


def _own_path(body: List[Instr], loop: Tuple[int, int], inner: Sequence[Tuple[int, int]],
              force: Optional[Dict[int, bool]] = None) -> List[Instr]:
    path = walk(body, loop[0], loop[1], force=force)
    spans = [(body[a].addr, body[b].addr) for a, b in inner]
    return [i for i in path if not any(lo <= i.addr <= hi for lo, hi in spans)]


def _local_loads(body: List[Instr], loop: Tuple[int, int]) -> int:
    return sum(i.base == "LDL" for i in body[loop[0]:loop[1] + 1])


def _day_steps(body: List[Instr]):
    """(loops, the outermost loop, the day loop, the loops directly inside
    it) of a regional kernel: the day loop is the outermost loop's largest
    inner loop where it spans at least half of it (the segment loop holds
    it), else the outermost loop."""
    loops = _loops(body)
    if not loops:
        raise ValueError("no loop (backward branch) in this function")
    top = max(loops, key=lambda lp: lp[1] - lp[0])
    day = max(_children(top, loops), key=lambda lp: lp[1] - lp[0], default=top)
    if 2 * (day[1] - day[0]) < top[1] - top[0]:
        day = top
    return loops, top, day, _children(day, loops)


def regional_census(body: List[Instr], coupled: bool, pooled: bool = False) -> dict:
    """Per-loop instruction counts of a regional kernel's day, by step:
    `day` (the day loop's own code), `coupled_rows` and `coupled_sum`
    (coupled models), `regions` and `channels` (the pooled copy when
    `pooled`); `shape_ok` is False, with the loop spans listed, where the
    function's loops are not that shape."""
    loops, top, day, steps = _day_steps(body)
    out = {"day_loop_span": [f"{body[day[0]].addr:04x}", f"{body[day[1]].addr:04x}"],
           "steps_spans": [[f"{body[a].addr:04x}", f"{body[b].addr:04x}"] for a, b in steps],
           "shape_ok": False, "day": _own(body, day, steps)}
    whole = walk(body, 0, len(body) - 1)
    out["per_sample_outside_loop"] = count(
        [i for i in whole if not body[top[0]].addr <= i.addr <= body[top[1]].addr])
    quarter = {lp: sum(opcode_class(i.opcode) == "quarter" for i in body[lp[0]:lp[1] + 1])
               for lp in steps}
    regions = [lp for lp in steps if quarter[lp] and quarter[lp] == max(quarter.values())]
    if len(regions) != 1:
        return out
    before = [lp for lp in steps if lp[1] < regions[0][0]]
    after = [lp for lp in steps if lp[0] > regions[0][1]]
    if not after or any(_children(lp, loops) for lp in after + regions):
        return out
    found = {"regions": regions[0],
             "channels": (min if pooled else max)(after, key=lambda lp: _local_loads(body, lp))}
    if coupled:
        rows = [lp for lp in before if _children(lp, loops)]
        if len(rows) != 1 or len(_children(rows[0], loops)) != 1:
            return out
        found["coupled_rows"] = rows[0]
        found["coupled_sum"] = _children(rows[0], loops)[0]
    for role, lp in found.items():
        out[role] = _own(body, lp, _children(lp, loops))
        out[f"{role}_span"] = [f"{body[lp[0]].addr:04x}", f"{body[lp[1]].addr:04x}"]
    out["shape_ok"] = True
    return out


def regional_per_day(result: dict, n_regions: int, rows: int) -> Dict[str, float]:
    """Instructions a sample-day by class from `regional_census`, each step
    times its trips: R regions, `rows` rows of summary channels (R, or 1
    pooled) and, coupled, R rows of R - 1 products after the first."""
    trips = {"day": 1, "regions": n_regions, "channels": rows, "coupled_rows": n_regions,
             "coupled_sum": n_regions * (n_regions - 1)}
    out = {c: 0.0 for c in CLASSES + ("total",)}
    for step, n in trips.items():
        for c, v in result.get(step, {}).items():
            out[c] += n * v
    return out


def regional_issue_floor_ms(result: dict, n_regions: int, rows: int, batch: int, days: int,
                            n_sm: int, clock_mhz: float) -> Optional[dict]:
    """`issue_floor_ms` of a regional kernel, or None where the census did
    not find its shape."""
    if not result["shape_ok"]:
        return None
    per_day = regional_per_day(result, n_regions, rows)
    return issue_floor_ms({"per_day": per_day,
                           "per_sample_outside_loop": result["per_sample_outside_loop"]},
                          batch, days, n_sm, clock_mhz)


#: region slots a lane of the warp route holds (MAX_REGIONS / 32)
WARP_SLOTS = 4


def _skips(body: List[Instr], n: int, index: Dict[int, int]) -> List[Instr]:
    return body[n + 1:index[body[n].target]]


def regional_warp_census(body: List[Instr], coupled: bool, pooled: bool = False) -> dict:
    """Per-loop warp-instruction counts of a warp-route kernel's day (module
    docstring): `day` (the day loop's own path with every region pass),
    `passes` (passes 1-3, each with its guard), `coupled_rows` (NR -> one
    trip of the row loop for NR regions a lane; coupled models), `chain`
    and `pooled_sum` (one trip each), with `pooled` choosing the path
    through the summary; `shape_ok` is False, with the spans listed, where
    the function's loops are not that shape."""
    _, top, day, steps = _day_steps(body)
    index = {i.addr: n for n, i in enumerate(body)}

    def inside(n):
        return any(a <= n <= b for a, b in steps)

    def span(lp):
        return [f"{body[lp[0]].addr:04x}", f"{body[lp[1]].addr:04x}"]

    out = {"day_loop_span": span(day), "steps_spans": [span(lp) for lp in steps],
           "shape_ok": False, "pooled": bool(pooled)}
    whole = walk(body, 0, len(body) - 1)
    out["per_sample_outside_loop"] = count(
        [i for i in whole if not body[top[0]].addr <= i.addr <= body[top[1]].addr])
    fwd = [n for n in range(day[0], day[1]) if not inside(n) and body[n].base == "BRA"
           and body[n].pred and body[n].target is not None
           and body[n].addr < body[n].target <= body[day[1]].addr]
    guards = [n for n in fwd if any(i.opcode.startswith("MUFU.RSQ")
                                    for i in _skips(body, n, index))]
    out["pass_guards"] = [f"{body[n].addr:04x}" for n in guards]
    if len(guards) != WARP_SLOTS - 1:
        return out
    after = [lp for lp in steps if lp[0] > index[body[guards[-1]].target]]
    chain = [lp for lp in after if any(i.opcode.startswith("LDS.128")
                                       for i in body[lp[0]:lp[1] + 1])]
    pool_loops = [lp for lp in after if lp not in chain]
    rows = [lp for lp in steps if lp[1] < guards[0]
            and any(i.base == "FMUL" for i in body[lp[0]:lp[1] + 1])]
    if len(chain) != 1 or len(pool_loops) != 1 or len(rows) != (WARP_SLOTS if coupled else 0):
        return out
    # every pass runs; the branch between the pooled sums and the chain goes
    # the launch's way
    force = {n: False for n in guards}
    for n in fwd:
        if index[body[n].target] > guards[-1] and n > guards[-1]:
            skipped = {i.addr for i in _skips(body, n, index)}
            holds_pool = body[pool_loops[0][0]].addr in skipped
            holds_chain = body[chain[0][0]].addr in skipped
            if holds_pool != holds_chain:
                force[n] = holds_pool != pooled
    path = _own_path(body, day, steps, force)
    out["day"] = count(path)
    passes = []
    for k, n in enumerate(guards):
        end = (body[guards[k + 1]].addr if k + 1 < len(guards)
               else body[index[body[n].target]].addr)
        passes.append(count([i for i in path if body[n].addr <= i.addr < end]))
    out["passes"] = passes
    fmul = {lp: sum(i.base == "FMUL" for i in body[lp[0]:lp[1] + 1]) for lp in rows}
    ordered = sorted(rows, key=lambda lp: fmul[lp])
    if len(set(fmul.values())) != len(rows):
        return out
    out["coupled_rows"] = {nr + 1: _own(body, lp, []) for nr, lp in enumerate(ordered)}
    out["coupled_rows_spans"] = {nr + 1: span(lp) for nr, lp in enumerate(ordered)}
    out["chain"], out["chain_span"] = _own(body, chain[0], []), span(chain[0])
    out["pooled_sum"], out["pooled_sum_span"] = _own(body, pool_loops[0], []), span(pool_loops[0])
    out["shape_ok"] = True
    return out


def regional_warp_per_day(result: dict, n_regions: int, n_chan: int) -> Dict[str, float]:
    """Warp-instructions a sample-day by class from `regional_warp_census`:
    the day with ceil(R / 32) region passes, the row loop for that many
    regions a lane ceil(R / 4) times (coupled), and the pooled sums R - 1
    times or the chain ceil(n_chan / 8) times, as the census walked."""
    nr = -(-n_regions // 32)
    out = {c: 0.0 for c in CLASSES + ("total",)}
    parts = [(result["day"], 1)] + [(p, -1) for p in result["passes"][nr - 1:]]
    if "coupled_rows" in result and result["coupled_rows"]:
        parts.append((result["coupled_rows"][nr], -(-n_regions // 4)))
    if result["pooled"]:
        parts.append((result["pooled_sum"], n_regions - 1))
    else:
        parts.append((result["chain"], -(-n_chan // 8)))
    for counts, n in parts:
        for c, v in counts.items():
            out[c] += n * v
    return out


def regional_warp_issue_floor_ms(result: dict, n_regions: int, n_chan: int, batch: int,
                                 days: int, n_sm: int, clock_mhz: float) -> Optional[dict]:
    """The issue floor of a warp-route launch, or None where the census did
    not find its shape.

    One warp runs one sample, so a warp-instruction is one issue slot (of 4
    a clock an SM) for one sample: floor = warp-instructions a sample-day x
    samples x days / (SMs x 4 x clock), and each class's pipe as many lanes
    a clock as in `issue_floor_ms`. That is `issue_floor_ms` with every
    count times 32: there a thread-instruction is 1/32 of an issue slot,
    because 32 samples share each warp-instruction."""
    if not result["shape_ok"]:
        return None
    per_day = regional_warp_per_day(result, n_regions, n_chan)
    lanes = {c: 32 * v for c, v in per_day.items()}
    outside = {c: 32 * v for c, v in result["per_sample_outside_loop"].items()}
    floor = issue_floor_ms({"per_day": lanes, "per_sample_outside_loop": outside},
                           batch, days, n_sm, clock_mhz)
    floor["warp_instructions_per_sample_day"] = floor.pop("instructions_per_sample_day") / 32
    return floor


def tile_region_census(body: List[Instr]) -> dict:
    """One trip of the tile route's region pass: the instructions of one
    city of one sample on one day, by class (`per_city_day`), along the
    path `walk`'s rules choose (the slow paths of division, sqrtf and cosf
    not taken). The pass is the loop whose own code holds the most
    quarter-rate instructions; `shape_ok` is False where no one loop does."""
    loops = _loops(body)

    def own_quarter(lp):
        inner = [(body[a].addr, body[b].addr) for a, b in _children(lp, loops)]
        return sum(opcode_class(i.opcode) == "quarter" for i in body[lp[0]:lp[1] + 1]
                   if not any(lo <= i.addr <= hi for lo, hi in inner))

    quarter = {lp: own_quarter(lp) for lp in loops}
    most = max(quarter.values(), default=0)
    best = [lp for lp in loops if most and quarter[lp] == most]
    if len(best) != 1:
        return {"shape_ok": False, "loops": len(loops)}
    head, back = best[0]
    return {"shape_ok": True, "per_city_day": _own(body, best[0], _children(best[0], loops)),
            "span": [f"{body[head].addr:04x}", f"{body[back].addr:04x}"]}


def tile_region_floor_ms(result: dict, n_regions: int, batch: int, days: int, n_sm: int,
                         clock_mhz: float) -> Optional[dict]:
    """The least time the card needs to issue the region passes of one
    tile launch (`n_regions` cities of `batch` samples over `days`, a trip
    each), by `issue_floor_ms`'s limits; None where the census did not find
    the pass."""
    if not result["shape_ok"]:
        return None
    per_day = {c: n_regions * v for c, v in result["per_city_day"].items()}
    floor = issue_floor_ms({"per_day": per_day,
                            "per_sample_outside_loop": {c: 0 for c in per_day}},
                           batch, days, n_sm, clock_mhz)
    floor["instructions_per_city_day"] = result["per_city_day"]["total"]
    return floor
