"""tracecheck engine for the port: the AST visitor framework and the
reachability of the code that runs inside the rounds (counterpart of
``repro.analysis.engine``).

The engine owns everything the rule modules share:

* :class:`ModuleContext`: one parsed file.  Import-alias resolution
  (``dist.all_reduce`` -> ``torch.distributed.all_reduce``), a
  qualified-name function table, a call and reference graph within the
  module, and the **round-reachability closure**.  JAX's "jit-reachable"
  becomes "reachable from a device-resident round or a CUDA-graph body":
  in eager PyTorch every operation those run is enqueued once a round,
  so a host sync there stalls every round and a Python loop is a launch
  a trip.  The roots are

  - the configured ``round_roots`` (``_Search.round``,
    ``_LaneSearch.round``, predict's ``_predict_body`` and
    ``_assign_body``);
  - every method of a class whose name ends in ``StatsBackend`` (and of
    its bases defined in the same module);
  - every module-level function under ``all_roots_paths`` (the kernel
    wrappers) but the ``host_boundary`` hooks;
  - the function arguments of the trace takers (``torch.compile``,
    ``torch.cuda.make_graphed_callables``, and the configured
    ``device_search`` / ``lane_search`` / ``adaptive_search``), and what
    a ``with torch.cuda.graph(...)`` block calls.

  Reachability follows call and reference edges, and enters functions
  defined inside reachable ones (a closure runs with its parent).
* Suppressions: ``# tracecheck: ignore[TRC00x] -- reason`` on the
  finding's line, or alone on the lines before it.  The reason is
  mandatory: a bare ``ignore[...]`` suppresses its target but raises
  TRC000.
* :class:`Finding`, the runner (:func:`run`), and the JSON and human
  reports, in the JAX package's schema.

The fit drivers' host code (the phases, the result assembly) is not
reachable by construction, so its reads never fire TRC001.  This module
is stdlib only.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .config import Config, path_in_scope

__all__ = [
    "Finding", "FuncInfo", "ModuleContext", "Report",
    "analyze_file", "run", "format_human", "report_to_json",
]

SUPPRESS_RE = re.compile(
    r"#\s*tracecheck:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(?:--\s*(\S.*))?")

# Callables whose function-valued arguments run on the device as one
# compiled or captured program.
TRACE_TAKERS = frozenset({"torch.compile",
                          "torch.cuda.make_graphed_callables"})

# Context managers whose block is captured as a CUDA graph.
GRAPH_CAPTURES = frozenset({"torch.cuda.graph"})

# The suffix of a stats backend's class name.
BACKEND_SUFFIX = "StatsBackend"

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    function: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def human(self) -> str:
        where = f" [{self.function}]" if self.function else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}{where} {self.message}")


@dataclasses.dataclass
class FuncInfo:
    qualname: str
    node: ast.AST                     # FunctionDef / AsyncFunctionDef / Lambda
    parent: Optional[str] = None      # qualname of enclosing *function*
    cls: Optional[str] = None         # name of enclosing class, if a method
    reach_reason: str = ""            # why reachable ("" = not reachable)


def qual_matches(qualname: str, name: str) -> bool:
    """True if ``name``'s dotted parts are a window of ``qualname``'s: a
    method ``"Reservoir.__init__"``, a class ``"SeedLayouts"``, a
    function ``"from_seed"``."""
    parts, want = qualname.split("."), name.split(".")
    return any(parts[i:i + len(want)] == want
               for i in range(len(parts) - len(want) + 1))


class _FuncCollector(ast.NodeVisitor):
    """Builds the function table with dotted qualified names."""

    def __init__(self) -> None:
        self.funcs: Dict[str, FuncInfo] = {}
        self.by_node: Dict[int, FuncInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self._scope: List[str] = []          # qualname parts
        self._func_stack: List[str] = []     # enclosing function qualnames
        self._class_stack: List[str] = []

    def _qual(self, name: str) -> str:
        return ".".join(self._scope + [name])

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.classes.setdefault(self._qual(node.name), node)
        self._scope.append(node.name)
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()
        self._scope.pop()

    def _visit_func(self, node) -> None:
        qual = self._qual(node.name)
        info = FuncInfo(
            qualname=qual,
            node=node,
            parent=self._func_stack[-1] if self._func_stack else None,
            cls=self._class_stack[-1] if self._class_stack else None,
        )
        # First definition wins for name collisions (rare; over-approx).
        self.funcs.setdefault(qual, info)
        self.by_node[id(node)] = info
        self._scope.append(node.name)
        self._func_stack.append(qual)
        self.generic_visit(node)
        self._func_stack.pop()
        self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


class ModuleContext:
    """One parsed source file plus everything the rules need to see."""

    def __init__(self, path: str, source: str, config: Config) -> None:
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.config = config
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.suppressions, self.bare_suppressions = self._parse_suppressions()
        self.aliases = self._collect_aliases()
        collector = _FuncCollector()
        collector.visit(self.tree)
        self.functions: Dict[str, FuncInfo] = collector.funcs
        self.classes: Dict[str, ast.ClassDef] = collector.classes
        self._by_node = collector.by_node
        self._lambda_roots: List[FuncInfo] = []
        self._simple_names: Dict[str, List[str]] = {}
        for qual in self.functions:
            self._simple_names.setdefault(qual.rsplit(".", 1)[-1],
                                          []).append(qual)
        self._edges = self._call_graph()
        self._reachable = self._reachability_closure()
        self._sanctioned = self._sanctioned_spans()

    # ---------------------------------------------------------- aliases

    def _collect_aliases(self) -> Dict[str, str]:
        amap: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        amap[a.asname] = a.name
                    else:
                        first = a.name.split(".", 1)[0]
                        amap[first] = first
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    amap[a.asname or a.name] = (
                        f"{mod}.{a.name}" if mod else a.name)
        return amap

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a Name/Attribute chain with aliases applied."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return None if base is None else f"{base}.{node.attr}"
        return None

    # ------------------------------------------------------ suppressions

    def _parse_suppressions(self) -> Tuple[Dict[int, Set[str]], List[int]]:
        sup: Dict[int, Set[str]] = {}
        bare: List[int] = []
        lines = self.source.splitlines()
        for i, line in enumerate(lines, 1):
            m = SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            code = line.split("#", 1)[0]
            if code.strip():
                target = i
            else:
                # Standalone comment: applies to the next code line, so a
                # multi-line justification block stays one suppression.
                target = i + 1
                for j in range(i, len(lines)):
                    stripped = lines[j].strip()
                    if stripped and not stripped.startswith("#"):
                        target = j + 1
                        break
            sup.setdefault(target, set()).update(rules)
            if not m.group(2):
                bare.append(i)
        return sup, bare

    def suppressed(self, rule: str, line: int) -> bool:
        return rule in self.suppressions.get(line, ())

    # -------------------------------------------------------- call graph

    def _local_targets(self, node: ast.AST) -> List[str]:
        """Local functions a Name/Attribute reference may point at."""
        if isinstance(node, ast.Name):
            if node.id in self.aliases and self.aliases[node.id] != node.id:
                return []  # shadowed by an import
            return list(self._simple_names.get(node.id, ()))
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in ("self", "cls")):
            return list(self._simple_names.get(node.attr, ()))
        return []

    def _call_graph(self) -> Dict[str, Set[str]]:
        edges: Dict[str, Set[str]] = {q: set() for q in self.functions}
        for info in self.functions.values():
            for node in self.walk_own(info.node):
                if isinstance(node, (ast.Name, ast.Attribute)):
                    for tgt in self._local_targets(node):
                        if tgt != info.qualname:
                            edges[info.qualname].add(tgt)
        return edges

    # ------------------------------------------------------ reachability

    def _is_banned(self, qual: str) -> bool:
        for b in self.config.host_boundary:
            if ":" in b:
                fname, name = b.split(":", 1)
                if not self.path.endswith("/" + fname) and \
                        self.path != fname:
                    continue
            else:
                name = b
            if qual == name or qual.endswith("." + name):
                return True
        return False

    def _callsite_roots(self) -> Iterator[Tuple[str, str]]:
        extra = set(self.config.extra_trace_takers)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            r = self.resolve(node.func)
            simple = r.rsplit(".", 1)[-1] if r else None
            if r not in TRACE_TAKERS and simple not in extra:
                continue
            taker = r or simple
            args = list(node.args) + [kw.value for kw in node.keywords]
            for a in args:
                if isinstance(a, ast.Lambda):
                    info = FuncInfo(
                        qualname=f"<lambda:{a.lineno}>", node=a,
                        reach_reason=f"lambda passed to {taker}")
                    self._lambda_roots.append(info)
                    continue
                for tgt in self._local_targets(a):
                    yield tgt, f"passed to {taker}"
                if isinstance(a, ast.Call):
                    # functools.partial(fn, ...) handed to a trace taker
                    pr = self.resolve(a.func)
                    if pr in ("functools.partial", "partial"):
                        for pa in a.args:
                            for tgt in self._local_targets(pa):
                                yield tgt, f"partial passed to {taker}"

    def _capture_roots(self) -> Iterator[Tuple[str, str]]:
        # with torch.cuda.graph(g): body(...)  -> body runs in the graph
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(isinstance(it.context_expr, ast.Call)
                       and self.resolve(it.context_expr.func)
                       in GRAPH_CAPTURES for it in node.items):
                continue
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        for tgt in self._local_targets(sub.func):
                            yield tgt, "called inside a CUDA-graph capture"

    def _backend_classes(self) -> Set[str]:
        """Qualnames of the stats backend classes and of their bases
        defined in this module (an inherited method is the backend's)."""
        out: Set[str] = set()
        for qual, node in self.classes.items():
            if node.name.endswith(BACKEND_SUFFIX) or any(
                    (self.resolve(b) or "").rsplit(".", 1)[-1].endswith(
                        BACKEND_SUFFIX) for b in node.bases):
                out.add(qual)
                for b in node.bases:
                    r = self.resolve(b)
                    if r in self.classes:
                        out.add(r)
        return out

    def _reachability_closure(self) -> Dict[str, str]:
        reach: Dict[str, str] = {}

        def add(qual: str, reason: str) -> None:
            if qual in self.functions and qual not in reach:
                if not self._is_banned(qual):
                    reach[qual] = reason

        for qual, reason in self._callsite_roots():
            add(qual, reason)
        for qual, reason in self._capture_roots():
            add(qual, reason)
        for qual in self.functions:
            for root in self.config.round_roots:
                if qual == root or qual.endswith("." + root):
                    add(qual, f"round root {root}")
        backends = self._backend_classes()
        for qual, info in self.functions.items():
            owner = qual.rsplit(".", 1)[0] if "." in qual else ""
            if info.cls is not None and owner in backends:
                add(qual, f"method of stats backend {owner}")
        if path_in_scope(self.path, self.config.all_roots_paths):
            for qual, info in self.functions.items():
                if info.parent is None and info.cls is None:
                    add(qual, "kernel-module public surface")

        changed = True
        while changed:
            changed = False
            for qual in list(reach):
                for succ in self._edges.get(qual, ()):
                    if succ not in reach:
                        add(succ, f"called from {qual}")
                        changed = succ in reach or changed
            for qual, info in self.functions.items():
                if qual in reach or info.parent is None:
                    continue
                if info.parent in reach:
                    add(qual, f"defined inside {info.parent}")
                    changed = qual in reach or changed

        for info in self.functions.values():
            info.reach_reason = reach.get(info.qualname, "")
        return reach

    # ------------------------------------------------- sanctioned syncs

    def is_sanctioned_sync(self, name: Optional[str]) -> bool:
        """True if the resolved or qualified ``name`` is one of the
        configured sanctioned sync points."""
        if not name:
            return False
        simple = name.rsplit(".", 1)[-1]
        return simple in self.config.sanctioned_syncs

    def _sanctioned_spans(self) -> Set[int]:
        """Ids of the nodes inside a ``with`` block of a sanctioned sync
        point (``with host_stage("..."):``, ``with syncs_allowed(dev):``)
        or inside the body of a sanctioned point itself."""
        out: Set[int] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(it.context_expr, ast.Call)
                       and self.is_sanctioned_sync(
                           self.resolve(it.context_expr.func))
                       for it in node.items):
                    for stmt in node.body:
                        out.update(id(n) for n in ast.walk(stmt))
            elif isinstance(node, _FUNC_DEFS) and \
                    node.name in self.config.sanctioned_syncs:
                out.update(id(n) for n in ast.walk(node))
        return out

    def in_sanctioned_span(self, node: ast.AST) -> bool:
        return id(node) in self._sanctioned

    # ---------------------------------------------------------- walking

    @staticmethod
    def walk_own(func_node: ast.AST) -> Iterator[ast.AST]:
        """Walk a function body without descending into nested defs.

        Lambdas ARE descended into: a lambda inside a reachable function
        runs with it, and lambdas have no table entry of their own unless
        passed straight to a trace taker.
        """
        body = getattr(func_node, "body", None)
        todo = list(body) if isinstance(body, list) else [body]
        while todo:
            n = todo.pop()
            if n is None or isinstance(n, _FUNC_DEFS):
                continue
            yield n
            todo.extend(ast.iter_child_nodes(n))

    def reachable_functions(self) -> Iterator[FuncInfo]:
        for info in self.functions.values():
            if info.reach_reason:
                yield info
        for info in self._lambda_roots:
            yield info

    def walk_scoped(self) -> Iterator[Tuple[ast.AST, str]]:
        """Yield every node with its enclosing function qualname ("" =
        module level)."""

        def rec(node: ast.AST, scope: str) -> Iterator[Tuple[ast.AST, str]]:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_DEFS):
                    info = self._by_node.get(id(child))
                    inner = info.qualname if info else child.name
                    yield child, scope
                    yield from rec(child, inner)
                else:
                    yield child, scope
                    yield from rec(child, scope)

        yield from rec(self.tree, "")

    def finding(self, rule: str, node: ast.AST, message: str,
                function: str = "") -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, function=function)


# ------------------------------------------------------------------ runner

@dataclasses.dataclass
class Report:
    findings: List[Finding]
    files_scanned: int
    suppressed: int

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


def _iter_py_files(paths: Iterable[str],
                   exclude: Tuple[str, ...]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if not path_in_scope(
                    os.path.join(root, d).replace(os.sep, "/") + "/",
                    exclude))
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def analyze_file(path: str, config: Config,
                 rules=None) -> Tuple[List[Finding], int]:
    """Run the rule pack on one file -> (findings, n_suppressed)."""
    from . import rules as rulepack
    if rules is None:
        rules = rulepack.ALL_RULES
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        ctx = ModuleContext(path, source, config)
    except SyntaxError as exc:
        return [Finding("TRC-PARSE", path.replace(os.sep, "/"),
                        exc.lineno or 0, exc.offset or 0,
                        f"could not parse: {exc.msg}")], 0

    findings: List[Finding] = []
    suppressed = 0
    for rule in rules:
        scope = config.rule_scope(rule.rule_id)
        if scope and not path_in_scope(ctx.path, scope):
            continue
        for f in rule.check(ctx, config):
            if ctx.suppressed(f.rule, f.line):
                suppressed += 1
            else:
                findings.append(f)
    # TRC000: suppression comments without a `-- reason` justification.
    for line in ctx.bare_suppressions:
        findings.append(Finding(
            "TRC000", ctx.path, line, 0,
            "suppression without justification — use "
            "`# tracecheck: ignore[RULE] -- <why this is safe>`"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, suppressed


def run(paths: Iterable[str], config: Config, rules=None) -> Report:
    findings: List[Finding] = []
    suppressed = 0
    n_files = 0
    for path in _iter_py_files(paths, config.exclude):
        n_files += 1
        fs, sup = analyze_file(path, config, rules=rules)
        findings.extend(fs)
        suppressed += sup
    return Report(findings=findings, files_scanned=n_files,
                  suppressed=suppressed)


# ----------------------------------------------------------------- output

def report_to_json(report: Report) -> dict:
    return {
        "tool": "tracecheck",
        "version": 1,
        "files_scanned": report.files_scanned,
        "suppressed": report.suppressed,
        "counts": report.counts,
        "findings": [f.to_json() for f in report.findings],
    }


def format_human(report: Report) -> str:
    lines = [f.human() for f in report.findings]
    tail = (f"{len(report.findings)} finding(s) in "
            f"{report.files_scanned} file(s), "
            f"{report.suppressed} suppressed")
    if report.findings:
        per_rule = ", ".join(f"{k}={v}" for k, v in report.counts.items())
        tail += f" [{per_rule}]"
    lines.append(tail)
    return "\n".join(lines)


def dump_json(report: Report, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(report_to_json(report), fh, indent=2, sort_keys=True)
        fh.write("\n")
