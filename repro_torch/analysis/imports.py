"""tracecheck import report for the port: live, test-only and dead
modules (counterpart of ``repro.analysis.imports``).

Builds the import graph within ``repro_torch`` by AST (module-level and
function-level imports, absolute and relative) and classifies every
module of the ``repro_torch/`` package at the repo root as

* ``live``: reachable from the product roots (``Config.product_roots``:
  ``repro_torch.api``, ``repro_torch.serve``, and this analysis package
  with its CLIs),
* ``test-only``: not reachable from the product but imported (through
  others or not) by the port's tests (``tests/test_torch_*.py``,
  ``tests/torch_*.py``) or its card scripts (``chip_*.py``),
* ``dead``: imported by nothing at all.

``check_quarantine`` makes the report a contract: every module that is
not live is listed in ``Config.quarantine`` (the LM scaffolding, with
the reason for each of the port's own entries), and nothing listed goes
live unnoticed: the list stays exact in both directions.  The walk
never enters ``build/``, which holds whole copies of the tree.  Stdlib
only.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, Iterable, List, Set, Tuple

from .config import Config

__all__ = ["build_report", "check_quarantine", "format_report",
           "PACKAGE", "EXTERNAL_GLOBS"]

PACKAGE = "repro_torch"
# The files outside the package whose imports make a module test-only.
EXTERNAL_GLOBS = ("tests/test_torch_*.py", "tests/torch_*.py", "chip_*.py")


def _module_name(path: str, pkg_root: str) -> str:
    rel = os.path.relpath(path, os.path.dirname(pkg_root))
    rel = rel.replace(os.sep, "/")
    rel = rel[:-3] if rel.endswith(".py") else rel
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


def _discover(pkg_root: str) -> Dict[str, str]:
    mods: Dict[str, str] = {}
    for root, dirs, files in os.walk(pkg_root):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "build"))
        for name in sorted(files):
            if name.endswith(".py"):
                p = os.path.join(root, name)
                mods[_module_name(p, pkg_root)] = p
    return mods


def _in_package(name: str) -> bool:
    return name == PACKAGE or name.startswith(PACKAGE + ".")


def _imports_of(path: str, modname: str, known: Set[str]) -> Set[str]:
    """``repro_torch.*`` modules this file imports (module granularity)."""
    with open(path, encoding="utf-8") as fh:
        try:
            tree = ast.parse(fh.read(), filename=path)
        except SyntaxError:
            return set()
    out: Set[str] = set()

    def add(candidate: str) -> None:
        # Trim attribute tails until we hit a known module.
        parts = candidate.split(".")
        while parts:
            cand = ".".join(parts)
            if cand in known:
                out.add(cand)
                return
            parts.pop()

    is_pkg = path.endswith("__init__.py")
    pkg_parts = modname.split(".") if is_pkg else modname.split(".")[:-1]

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if _in_package(a.name):
                    add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
                if not _in_package(base):
                    continue
            else:
                up = node.level - 1
                if up > len(pkg_parts):
                    continue
                base_parts = pkg_parts[: len(pkg_parts) - up] if up else \
                    list(pkg_parts)
                base = ".".join(base_parts + (
                    [node.module] if node.module else []))
            if base:
                add(base)
            for a in node.names:
                if a.name != "*" and base:
                    add(f"{base}.{a.name}")
    out.discard(modname)
    return out


# Some tests and scripts run code in subprocesses from string literals
# (``python -c``, ``-m``); their imports are invisible to the AST, so the
# external scan also greps the raw text.
_TEXT_IMPORT_RE = re.compile(
    r"(?:from\s+(repro_torch(?:\.\w+)*)\s+import)"
    r"|(?:\bimport\s+(repro_torch(?:\.\w+)+))"
    r"|(?:-m\s+(repro_torch(?:\.\w+)+))")


def _external_files(repo_root: str,
                    patterns: Iterable[str]) -> List[str]:
    out: Set[str] = set()
    for pat in patterns:
        out.update(glob.glob(os.path.join(repo_root, pat)))
    return sorted(out)


def _external_roots(repo_root: str, known: Set[str],
                    patterns: Iterable[str]) -> Dict[str, Set[str]]:
    """Package modules imported by the tests and scripts -> importers."""
    roots: Dict[str, Set[str]] = {}
    for p in _external_files(repo_root, patterns):
        rel = os.path.relpath(p, repo_root).replace(os.sep, "/")
        mods = _imports_of(p, f"<{rel}>", known)
        with open(p, encoding="utf-8") as fh:
            for m in _TEXT_IMPORT_RE.finditer(fh.read()):
                cand = m.group(1) or m.group(2) or m.group(3)
                parts = cand.split(".")
                while parts:
                    if ".".join(parts) in known:
                        mods.add(".".join(parts))
                        break
                    parts.pop()
        for mod in mods:
            roots.setdefault(mod, set()).add(rel)
    return roots


def _closure(seeds: Iterable[str], graph: Dict[str, Set[str]]) -> Set[str]:
    seen: Set[str] = set()
    todo = list(seeds)
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        todo.extend(graph.get(m, ()))
        # Importing a submodule executes the package __init__ too.
        if "." in m:
            todo.append(m.rsplit(".", 1)[0])
    return seen


def build_report(repo_root: str, config: Config,
                 patterns: Iterable[str] = EXTERNAL_GLOBS
                 ) -> Dict[str, dict]:
    """Every module of ``<repo_root>/repro_torch``: its class, its path
    and its importers."""
    pkg_root = os.path.join(repo_root, PACKAGE)
    mods = _discover(pkg_root)
    known = set(mods)
    graph = {m: _imports_of(p, m, known) for m, p in mods.items()}

    # Exact-module seeds: importing a package root executes its __init__,
    # whose own imports are edges in the graph, so submodules go live only
    # if the package (or another live module) actually pulls them in.
    product_seeds = [r for r in config.product_roots if r in known]
    live = _closure(product_seeds, graph)

    ext = _external_roots(repo_root, known, patterns)
    test_reach = _closure(ext.keys(), graph)

    importers: Dict[str, Set[str]] = {m: set() for m in known}
    for m, deps in graph.items():
        for d in deps:
            importers[d].add(m)
    for m, files in ext.items():
        importers[m].update(files)

    report: Dict[str, dict] = {}
    for m in sorted(known):
        if m in live:
            status = "live"
        elif m in test_reach:
            status = "test-only"
        else:
            status = "dead"
        report[m] = {
            "status": status,
            "path": os.path.relpath(mods[m], repo_root).replace(os.sep, "/"),
            "imported_by": sorted(importers[m]),
        }
    return report


def check_quarantine(report: Dict[str, dict],
                     config: Config) -> Tuple[List[str], List[str]]:
    """-> (undocumented dormant modules, stale quarantine entries)."""
    quarantined = set(config.quarantine)
    dormant = {m for m, info in report.items()
               if info["status"] != "live"}
    undocumented = sorted(dormant - quarantined)
    stale = sorted(q for q in quarantined
                   if q in report and report[q]["status"] == "live")
    return undocumented, stale


def format_report(report: Dict[str, dict], config: Config) -> str:
    lines = []
    counts = {"live": 0, "test-only": 0, "dead": 0}
    for m, info in report.items():
        counts[info["status"]] += 1
        if info["status"] != "live":
            q = " (quarantined)" if m in config.quarantine else ""
            by = ", ".join(info["imported_by"][:3]) or "nothing"
            lines.append(f"  {info['status']:9s} {m}{q}  <- {by}")
    undocumented, stale = check_quarantine(report, config)
    head = (f"import graph: {counts['live']} live, "
            f"{counts['test-only']} test-only, {counts['dead']} dead")
    lines.insert(0, head)
    if undocumented:
        lines.append("UNDOCUMENTED dormant modules (add to quarantine or "
                     "delete): " + ", ".join(undocumented))
    if stale:
        lines.append("STALE quarantine entries (module is live): "
                     + ", ".join(stale))
    return "\n".join(lines)
