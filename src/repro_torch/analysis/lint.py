"""AST lint pass over the port: its contracts as named, suppressible rules
(port of `repro.analysis.lint`).

  non-atomic-artifact-write   artifacts go through repro_torch.ioutils
                              .atomic_write: a bare np.savez / json.dump /
                              pickle.dump / open(path, "w") /
                              Path.write_text to a final path can leave a
                              truncated file there.
  host-sync-in-wave-loop      .item() / .cpu() / .numpy() / .tolist() /
                              torch.cuda.synchronize(), or float() / int() /
                              bool() / np.asarray of a non-literal, inside a
                              device loop: each makes the host wait for the
                              card once a wave, where the loop's contract is
                              one host sync a segment.
  suppression-missing-reason  `# analysis: allow(rule)` without a reason
                              comment: suppressions must say why.

The device loops are registered by file and qualified name (`DEVICE_LOOPS`):
the ABC and sharded wave runners, the SMC round and the campaign's round
loop. In a registered function the rule checks the bodies of its `for` and
`while` loops; a function that such a body calls
by simple name, defined in the same module or imported by name from another
module of the lint's scope, runs once a wave, so its whole body is checked,
and so on down its own simple-name calls. A registered function that is no
longer there is itself a finding, so that a rename cannot switch the rule
off. `core.abc.sync_counts` is the loops' one sanctioned sync and carries a
suppression with its reason.

Not ported: `repro`'s `python-rng-under-trace`, `time-under-trace` and
`scalar-closure-capture`. They guard values that tracing bakes into a
compiled program; eager PyTorch compiles nothing, so a host draw, a clock
read or a captured scalar is read afresh at every call.

Suppression: a trailing comment on the flagged line, or a comment in the
contiguous comment block directly above it, of the form

    # analysis: allow(rule-name) — reason why this site is exempt
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Finding

#: rule registry: name -> one-line description
RULES: Dict[str, str] = {
    "non-atomic-artifact-write": (
        "artifact writes must go through repro_torch.ioutils.atomic_write "
        "(bare np.savez/np.save/json.dump/pickle.dump/open(...,'w')/"
        "Path.write_text can leave a truncated file at the final path)"
    ),
    "host-sync-in-wave-loop": (
        ".item()/.cpu()/.numpy()/.tolist()/torch.cuda.synchronize(), or "
        "float()/int()/bool()/np.asarray of a non-literal, inside a device "
        "loop (its contract: one host sync a segment)"
    ),
    "suppression-missing-reason": (
        "# analysis: allow(...) suppressions must carry a reason"
    ),
}

#: the port's device loops: file -> qualified names of the functions whose
#: loop bodies run a wave (or a round) an iteration
DEVICE_LOOPS: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/core/abc.py": ("WaveRunner.__call__",),
    "src/repro_torch/core/distributed.py": ("ShardedWaveRunner.__call__",
                                            "PjitWaveRunner.__call__"),
    "src/repro_torch/core/smc.py": ("make_smc_round_fn.round_fn",),
    "src/repro_torch/core/campaign.py": ("run_campaign",),
}

_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}
_HOST_CONVERTERS = {"float", "int", "bool"}
_NP_ALIASES = {"np", "numpy"}
_WRITE_MODES = {"w", "wb", "a", "ab", "w+", "wb+", "a+", "x", "xb"}
#: file-writing calls checked by non-atomic-artifact-write:
#: dotted-suffix -> index of the file-object/path argument
_FILE_ARG_OF = {"savez": 0, "savez_compressed": 0, "save": 0, "dump": 1}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([A-Za-z0-9_-]+)\)\s*(.*)")


def _dotted(node: ast.AST) -> Tuple[str, ...]:
    """('torch', 'cuda', 'synchronize') for torch.cuda.synchronize; () if
    not a dotted name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


class _Suppressions:
    """Per-file `# analysis: allow(rule) — reason` directives."""

    def __init__(self, source: str, path: str):
        self.by_line: Dict[int, Set[str]] = {}
        self.missing_reason: List[Finding] = []
        self._comment_lines: Set[int] = set()
        for i, raw in enumerate(source.splitlines(), start=1):
            if raw.strip().startswith("#"):
                self._comment_lines.add(i)
            m = _ALLOW_RE.search(raw)
            if not m:
                continue
            rule, reason = m.group(1), m.group(2)
            self.by_line.setdefault(i, set()).add(rule)
            if not reason.strip(" -—:\t"):
                self.missing_reason.append(Finding(
                    rule="suppression-missing-reason", path=path, line=i,
                    context=f"allow({rule})",
                    message="suppression has no reason — say why this site is exempt "
                            "after the closing paren",
                ))

    def allows(self, rule: str, line: int) -> bool:
        """Directive on the line itself or in the comment block above it."""
        if rule in self.by_line.get(line, ()):
            return True
        lookback = line - 1
        while lookback in self._comment_lines:
            if rule in self.by_line.get(lookback, ()):
                return True
            lookback -= 1
        return False


def _module_name(rel: str) -> str:
    """src/repro_torch/core/abc.py -> repro_torch.core.abc."""
    parts = Path(rel).with_suffix("").parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Module:
    """One parsed file: its functions by qualified name and the names it
    imports by name from other modules."""

    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.tree = ast.parse(source, filename=rel)
        self.functions: Dict[str, ast.AST] = {}
        self.imports: Dict[str, Tuple[str, str]] = {}  # local name -> (module, name)
        self._index(self.tree, "")
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (node.module, alias.name)

    def _index(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + child.name
                self.functions[qual] = child
                self._index(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                self._index(child, prefix + child.name + ".")
            else:
                self._index(child, prefix)

    def resolve(self, caller: str, name: str) -> Optional[str]:
        """The qualified name in this module that `name`, called from
        `caller`, binds: a def nested in the caller's scope chain, innermost
        first, then a module-level def (a method is not a scope)."""
        scope = caller.split(".")
        while scope:
            qual = ".".join(scope + [name])
            if qual in self.functions and not self._is_method_scope(scope):
                return qual
            scope = scope[:-1]
        return name if name in self.functions else None

    def _is_method_scope(self, scope: List[str]) -> bool:
        """Whether `scope` names a class (its defs are methods, not names in
        scope for code inside the class's methods)."""
        return ".".join(scope) not in self.functions


def _own_nodes(roots: Sequence[ast.AST]) -> Iterator[ast.AST]:
    """Every node of `roots` and under them, less nested defs and lambdas:
    those are functions of their own."""
    stack = [r for r in roots if not isinstance(r, _DEFS)]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, _DEFS):
                stack.append(child)


def _loop_bodies(fn: ast.AST) -> List[ast.AST]:
    """The statements of `fn` that run once an iteration of one of its
    `for`/`while` loops."""
    out: List[ast.AST] = []
    for node in _own_nodes(fn.body):
        if isinstance(node, _LOOPS):
            out.extend(node.body)
    return out


def _sync_call(node: ast.Call) -> Optional[str]:
    """What makes `node` a host sync, or None."""
    callee = _dotted(node.func)
    if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
        return f".{node.func.attr}() reads the device from the host"
    if callee and callee[-1] == "synchronize" and "cuda" in callee:
        return "torch.cuda.synchronize() waits for the card"
    literal = bool(node.args) and isinstance(node.args[0], ast.Constant)
    if callee in {(c,) for c in _HOST_CONVERTERS} and node.args and not literal:
        return f"{callee[0]}() of a non-literal reads a tensor's value on the host"
    if (len(callee) == 2 and callee[0] in _NP_ALIASES and callee[1] in ("asarray", "array")
            and node.args and not literal):
        return f"{'.'.join(callee)}() of a non-literal copies a tensor to the host"
    return None


class _Project:
    """The files of one lint run, their modules and the device loops'
    reach: which functions run in a loop body, found across modules."""

    def __init__(self, sources: Dict[str, str],
                 device_loops: Optional[Dict[str, Sequence[str]]] = None):
        self.modules = {rel: _Module(rel, src) for rel, src in sources.items()}
        self.by_name = {_module_name(rel): m for rel, m in self.modules.items()}
        loops = DEVICE_LOOPS if device_loops is None else device_loops
        self.roots = {rel: tuple(q) for rel, q in loops.items() if rel in self.modules}
        #: rel -> qualified names whose whole body runs once a wave
        self.wave_fns: Dict[str, Set[str]] = {rel: set() for rel in self.modules}
        self._reach()

    def _callees(self, mod: _Module, caller: str, nodes: Sequence[ast.AST]):
        for node in nodes:
            for sub in _own_nodes([node]):
                if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                    hit = self._resolve(mod, caller, sub.func.id)
                    if hit is not None:
                        yield hit

    def _resolve(self, mod: _Module, caller: str, name: str):
        qual = mod.resolve(caller, name)
        if qual is not None:
            return mod.rel, qual
        if name in mod.imports:
            module, orig = mod.imports[name]
            other = self.by_name.get(module)
            if other is not None and orig in other.functions:
                return other.rel, orig
        return None

    def _reach(self) -> None:
        todo = []
        for rel, quals in self.roots.items():
            mod = self.modules[rel]
            for qual in quals:
                fn = mod.functions.get(qual)
                if fn is not None:
                    todo.extend(self._callees(mod, qual, _loop_bodies(fn)))
        while todo:
            rel, qual = todo.pop()
            if qual in self.wave_fns[rel]:
                continue
            self.wave_fns[rel].add(qual)
            mod = self.modules[rel]
            todo.extend(self._callees(mod, qual, mod.functions[qual].body))


class Linter:
    """Lint one file; collect Findings (suppressions already applied).

    `project` is the lint run the file belongs to (`run_lint` makes one for
    all files); without one the file is its own project, its device loops
    `device_loops` (qualified names) or those `DEVICE_LOOPS` registers for
    its path."""

    def __init__(self, path: Path, repo_root: Path, source: Optional[str] = None,
                 device_loops: Optional[Sequence[str]] = None,
                 project: Optional[_Project] = None):
        self.path = path
        self.rel = str(path.relative_to(repo_root))
        self.source = source if source is not None else path.read_text()
        self.findings: List[Finding] = []
        self.suppressions = _Suppressions(self.source, self.rel)
        if project is None:
            loops = None if device_loops is None else {self.rel: tuple(device_loops)}
            project = _Project({self.rel: self.source}, loops)
        self.project = project

    # ------------------------------------------------------------------
    def run(self) -> List[Finding]:
        module = self.project.modules[self.rel]
        tree = module.tree
        self._enclosing: Dict[int, str] = {}
        for qual, fn in sorted(module.functions.items(), key=lambda kv: -kv[1].lineno):
            for child in ast.walk(fn):
                lineno = getattr(child, "lineno", None)
                if lineno is not None and lineno not in self._enclosing:
                    self._enclosing[lineno] = qual
        if not self.rel.endswith("ioutils.py"):
            self._check_atomic_writes(tree)
        for qual in self.project.roots.get(self.rel, ()):
            fn = module.functions.get(qual)
            if fn is None:
                self.findings.append(Finding(
                    rule="host-sync-in-wave-loop", path=self.rel, line=0, context=qual,
                    message=f"registered device loop {qual} is not in the file; update "
                            "DEVICE_LOOPS (repro_torch/analysis/lint.py)"))
                continue
            self._check_syncs(qual, _loop_bodies(fn), f"a loop of device loop {qual}")
        for qual in sorted(self.project.wave_fns.get(self.rel, ())):
            self._check_syncs(qual, module.functions[qual].body,
                              f"{qual}, which a device loop calls once an iteration")
        self.findings.extend(self.suppressions.missing_reason)
        return self.findings

    # ------------------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, context: str, message: str):
        line = getattr(node, "lineno", 0)
        if self.suppressions.allows(rule, line):
            return
        self.findings.append(Finding(rule=rule, path=self.rel, line=line, context=context,
                                     message=message))

    def _context_of(self, node: ast.AST) -> str:
        return self._enclosing.get(getattr(node, "lineno", 0), "<module>")

    # ------------------------------------------- rule: host-sync-in-wave-loop
    def _check_syncs(self, qual: str, nodes: Sequence[ast.AST], where: str):
        for node in _own_nodes(nodes):
            if isinstance(node, ast.Call):
                why = _sync_call(node)
                if why is not None:
                    self._emit("host-sync-in-wave-loop", node, qual, f"{why} in {where}")

    # ------------------------------------- rule: non-atomic-artifact-write
    def _check_atomic_writes(self, tree: ast.Module):
        # names bound as `with atomic_write(...) as f` anywhere in the file
        atomic_handles: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    call = item.context_expr
                    if (isinstance(call, ast.Call)
                            and _dotted(call.func)[-1:] == ("atomic_write",)
                            and isinstance(item.optional_vars, ast.Name)):
                        atomic_handles.add(item.optional_vars.id)

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func)
            ctx = self._context_of(node)
            if callee == ("open",):
                mode = None
                if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                    mode = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and mode in _WRITE_MODES:
                    self._emit("non-atomic-artifact-write", node, ctx,
                               f"open(..., {mode!r}) writes the final path directly; use "
                               "`with atomic_write(path, ...)` instead")
            elif callee and callee[-1] == "write_text" and len(callee) > 1:
                self._emit("non-atomic-artifact-write", node, ctx,
                           ".write_text() replaces the file non-atomically; use "
                           "repro_torch.ioutils.atomic_write_text")
            elif callee and callee[-1] in _FILE_ARG_OF and len(callee) > 1:
                # np.savez/np.save/json.dump/pickle.dump(file_or_path, ...)
                if (callee[-1] in ("savez", "savez_compressed", "save")
                        and callee[0] not in _NP_ALIASES):
                    continue
                if callee[-1] == "dump" and callee[0] not in ("json", "pickle", "yaml",
                                                              "toml"):
                    continue
                idx = _FILE_ARG_OF[callee[-1]]
                file_arg = node.args[idx] if len(node.args) > idx else None
                if isinstance(file_arg, ast.Name) and file_arg.id in atomic_handles:
                    continue
                self._emit("non-atomic-artifact-write", node, ctx,
                           f"{'.'.join(callee)} must write through a "
                           "`with atomic_write(path, ...)` handle")


def default_targets(repo_root: Path) -> List[Path]:
    """The lint scope: src/repro_torch and chip_smoke.py."""
    targets = sorted((repo_root / "src" / "repro_torch").rglob("*.py"))
    smoke = repo_root / "chip_smoke.py"
    return targets + ([smoke] if smoke.exists() else [])


def run_lint(repo_root: Path, paths: Optional[List[Path]] = None) -> List[Finding]:
    paths = paths or default_targets(repo_root)
    sources = {str(p.relative_to(repo_root)): p.read_text() for p in paths}
    project = _Project(sources)
    findings: List[Finding] = []
    for path in paths:
        findings.extend(Linter(path, repo_root, source=sources[str(path.relative_to(repo_root))],
                               project=project).run())
    return findings
