"""graphcheck rule engine for the port: the graph contracts GRC000–GRC006
(counterpart of ``repro.analysis.graph.rules``).

tracecheck polices what the *source* may say; these rules police what an
entry point actually does when it runs.  The JAX rules read a jaxpr, the
lowered text and the compiled memory analysis; the port's read one run of
the registered entry point at the canonical shapes (``survey``: the ops a
``TorchDispatchMode`` sees, and the hand-written kernels' launch counts):

* GRC000 golden drift: the run's op census no longer matches the
  committed golden for the running PyTorch version and device type
  (reported op by op).
* GRC001 memory budget: the entry point's peak temporaries on the card
  (``analysis.budgets.measure``, the allocator's peak over the call)
  exceed its declared bound.  It measures a CUDA allocator, so it is
  skipped on the CPU with a note.
* GRC002 materialisation: a streaming entry point makes an output with
  two axes or more at dataset extent (the [n, n]-class block the
  streaming paths exist to avoid).
* GRC003 collective census: the collectives the dispatcher saw differ
  from the spec's declaration.  The port makes one ``all_reduce`` of the
  three stacked moments a round enqueued (masked rounds included) and
  one a carried repair, so a sharded spec declares the count of its own
  run (``distributed.allreduce_counts()``); every other spec declares
  zero (a collective smuggled into backend code is the runtime twin of
  TRC004).
* GRC004 transfer census: a host read (``aten._local_scalar_dense``) or
  a copy across devices inside a hot entry point, outside the sanctioned
  spans (``engine.host_read`` / ``host_stage`` / ``phase_sync``); an
  upload from pinned memory without a wait is not one.
* GRC005 donation, the port's form: the carried buffers a spec declares
  (the PIC rings) are written in place: their storage is the same after
  the call, and no copy-class op (``clone``, ``cat``, ``_to_copy``, an
  out-of-place scatter, ...) makes a fresh tensor of their shape and
  dtype.  The check holds each buffer's storage through the call, so
  the allocator cannot hand its block to a replacement, and a new
  storage shows as a new address.
* GRC006 dtype discipline: more narrowing float casts than the spec's
  audited allowance.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...core.device import resolve_device
from . import survey as sv_mod
from .entrypoints import GraphSpec, Prepared, pinned_tiles, registry

__all__ = ["Finding", "Report", "ALL_RULES", "RULE_DOCS", "analyze",
           "format_human", "report_to_json", "default_backend"]

ALL_RULES = ("GRC000", "GRC001", "GRC002", "GRC003", "GRC004", "GRC005",
             "GRC006")

RULE_DOCS = {
    "GRC000": "golden fingerprint drift (op census changed at canonical "
              "shapes)",
    "GRC001": "peak temporaries on the card exceed the declared memory "
              "budget",
    "GRC002": "materialised [n, n]-class intermediate in a streaming "
              "entrypoint",
    "GRC003": "collective census differs from the declared all_reduce "
              "count",
    "GRC004": "host read or cross-device copy (outside the sanctioned "
              "spans) in a hot entrypoint",
    "GRC005": "declared carried buffers are not written in place",
    "GRC006": "unaudited narrowing float cast in the run",
}

_FLOAT_BITS = {"float64": 64, "float32": 32, "float16": 16, "bfloat16": 16}
# The dispatcher's spellings of an all-reduce (namespace and overload
# dropped); every other collective is counted under its own name.
_ALL_REDUCE = ("allreduce_", "all_reduce", "all_reduce_")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    entrypoint: str
    message: str


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    entrypoints: List[str]
    notes: List[str]
    skipped_budgets: bool = False
    # name -> what the run did: kernel launches, transfers, collectives,
    # narrowing casts, wall seconds
    details: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def default_backend(device) -> str:
    """The stats backend the registry runs on ``device``: the kernels on
    the card, the plain versions elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _narrowing(converts) -> List[Tuple[str, str]]:
    out = []
    for src, dst in converts:
        sb, db = _FLOAT_BITS.get(src), _FLOAT_BITS.get(dst)
        if sb is not None and db is not None and db < sb:
            out.append((src, dst))
    return out


def collective_census(sv: sv_mod.Survey) -> Dict[str, int]:
    """The dispatcher's collectives by census key (``all_reduce``, ...)."""
    out: Dict[str, int] = {}
    for op, n in sv.collectives.items():
        base = op.split(".")[1] if "." in op else op
        key = "all_reduce" if base in _ALL_REDUCE else base
        out[key] = out.get(key, 0) + n
    return out


def _check_run_rules(spec: GraphSpec, prep: Prepared, sv: sv_mod.Survey,
                     findings: List[Finding]) -> None:
    # GRC002: materialisation in streaming entry points
    if "streaming" in spec.tags:
        seen = set()
        for op, shape in sv.big_outs:
            big_axes = sum(1 for s in shape if s >= spec.n)
            if big_axes >= 2 and (op, shape) not in seen:
                seen.add((op, shape))
                findings.append(Finding(
                    "GRC002", spec.name,
                    f"materialised intermediate {list(shape)} from "
                    f"'{op}' (>= 2 axes at dataset extent n={spec.n})"))
    # GRC003: collective census against the declaration
    declared = prep.collectives() if prep.collectives else {}
    got = collective_census(sv)
    for key in sorted(set(declared) | set(got)):
        if got.get(key, 0) != int(declared.get(key, 0)):
            findings.append(Finding(
                "GRC003", spec.name,
                f"{key} count {got.get(key, 0)} != declared "
                f"{int(declared.get(key, 0))}"))
    # GRC004: transfers
    kinds: Dict[str, int] = {}
    for op, what in sv.transfers:
        kinds[f"{op} {what}".strip()] = kinds.get(f"{op} {what}".strip(),
                                                  0) + 1
    for what, count in sorted(kinds.items()):
        findings.append(Finding(
            "GRC004", spec.name,
            f"transfer '{what}' x{count} inside a hot entrypoint"))
    # GRC006: narrowing casts
    narrowing = _narrowing(sv.converts)
    if len(narrowing) > spec.allowed_narrowing:
        findings.append(Finding(
            "GRC006", spec.name,
            f"{len(narrowing)} narrowing float cast(s) "
            f"{sorted(set(narrowing))}, allowance "
            f"{spec.allowed_narrowing}"))


def _carried(prep: Prepared
             ) -> List[Tuple[torch.UntypedStorage, Tuple[int, ...], str]]:
    """(storage, shape, dtype) of each carried buffer now.  Holding the
    storage keeps its block allocated until the caller drops the list, so
    no tensor made meanwhile can take its address."""
    return [(t.untyped_storage(), tuple(t.shape), str(t.dtype))
            for t in (prep.carried() if prep.carried else ())]


def _check_donation(spec: GraphSpec, prep: Prepared, sv: sv_mod.Survey,
                    before, findings: List[Finding]) -> None:
    for t, (st0, shape, dtype) in zip(prep.carried() if prep.carried
                                      else (), before):
        ptr0 = st0.data_ptr()
        if t.untyped_storage().data_ptr() != ptr0:
            findings.append(Finding(
                "GRC005", spec.name,
                f"carried buffer {list(shape)} {dtype} was replaced: its "
                f"storage moved over the call (an out-of-place write)"))
            continue
        fresh = sorted({op for op, s, dt, ptr in sv.copies
                        if s == shape and dt == dtype and ptr != ptr0})
        if fresh:
            findings.append(Finding(
                "GRC005", spec.name,
                f"fresh copy of carried buffer {list(shape)} {dtype} made "
                f"by {fresh}: the buffer must be written in place"))


def _check_budget(spec: GraphSpec, device, findings: List[Finding]) -> None:
    from .. import budgets
    m = budgets.measure(spec.budget, device=device)
    if m.temp > m.bound:
        findings.append(Finding(
            "GRC001", spec.name,
            f"peak temporaries {m.temp:,} B exceed budget {m.bound:,} B "
            f"[{budgets.budget_doc(spec.budget)}] at {m.shape}"))


def _check_drift(spec: GraphSpec, doc: Dict, golden_doc, key: str,
                 findings: List[Finding]) -> None:
    vgold = sv_mod.golden_for_key(golden_doc, key)
    if vgold is None:
        return  # key-level note emitted once by analyze()
    old = vgold.get(spec.name)
    if old is None:
        findings.append(Finding(
            "GRC000", spec.name,
            f"no committed golden fingerprint for {key} — regenerate "
            f"with {sv_mod.GOLDEN_ENV}=1"))
        return
    if old.get("hash") != doc.get("hash"):
        findings.append(Finding(
            "GRC000", spec.name,
            "graph drift vs committed golden:\n"
            + sv_mod.diff_fingerprints(old, doc)))


def analyze(specs: Optional[Sequence[GraphSpec]] = None, *,
            device=None, backend: Optional[str] = None,
            golden_doc: Optional[Dict] = None,
            rules: Optional[Sequence[str]] = None,
            with_budgets: bool = True) -> "tuple[Report, Dict[str, Dict]]":
    """Run every spec once on ``device`` (None: the card, raising without
    one; its ``backend``, by default :func:`default_backend`) and the
    rules; returns (report, fingerprints by name)."""
    specs = registry() if specs is None else specs
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    active = set(ALL_RULES if rules is None else rules)
    key = sv_mod.golden_key(dev)
    findings: List[Finding] = []
    notes: List[str] = []
    prints: Dict[str, Dict] = {}
    details: Dict[str, Dict] = {}

    if "GRC000" in active and golden_doc is not None and \
            sv_mod.golden_for_key(golden_doc, key) is None:
        notes.append(
            f"no goldens committed for {key} (have: "
            f"{sorted(golden_doc.get('goldens', {}))}); GRC000 drift not "
            f"evaluated")
    budgets_on = with_budgets and dev.type == "cuda"

    for spec in specs:
        with pinned_tiles():
            prep = spec.build(dev, backend)
            try:
                before = _carried(prep)
                t0 = time.perf_counter()
                sv, _ = sv_mod.survey(prep.call, dev, prep.inputs)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                ruled: List[Finding] = []
                _check_run_rules(spec, prep, sv, ruled)
                _check_donation(spec, prep, sv, before, ruled)
            finally:
                before = None  # the held storages go with the spec's state
                if prep.cleanup is not None:
                    prep.cleanup()
        doc = sv_mod.fingerprint(sv)
        prints[spec.name] = doc
        details[spec.name] = {
            "launches": dict(sv.launches),
            "transfers": len(sv.transfers),
            "collectives": collective_census(sv),
            "narrowing": len(_narrowing(sv.converts)),
            "ops": sum(n for op, n in sv.census.items()
                       if not op.startswith("kernel:")),
            "wall_s": wall,
        }
        if "GRC001" in active and spec.budget is not None and budgets_on:
            _check_budget(spec, dev, ruled)
        if "GRC000" in active and golden_doc is not None:
            _check_drift(spec, doc, golden_doc, key, ruled)
        findings.extend(f for f in ruled if f.rule in active)

    skipped = [s.name for s in specs if s.budget is not None]
    if skipped and "GRC001" in active and not budgets_on:
        why = ("--skip-budgets" if dev.type == "cuda" else
               "they measure the card's allocator")
        notes.append(f"budgets skipped for {len(skipped)} "
                     f"entrypoint(s) ({why})")
    report = Report(findings=findings, entrypoints=[s.name for s in specs],
                    notes=notes, skipped_budgets=not budgets_on,
                    details=details)
    return report, prints


def format_human(report: Report) -> str:
    lines = []
    for f in report.findings:
        lines.append(f"{f.rule} {f.entrypoint}: {f.message}")
    for n in report.notes:
        lines.append(f"note: {n}")
    lines.append(f"{len(report.findings)} finding(s) across "
                 f"{len(report.entrypoints)} entrypoint(s)")
    return "\n".join(lines)


def report_to_json(report: Report, prints: Optional[Dict] = None,
                   device=None) -> Dict:
    doc = {
        "tool": "graphcheck",
        "version": 1,
        "torch": torch.__version__,
        "key": sv_mod.golden_key(device),
        "entrypoints": report.entrypoints,
        "counts": report.counts,
        "findings": [dataclasses.asdict(f) for f in report.findings],
        "notes": list(report.notes),
        "details": report.details,
    }
    if prints is not None:
        doc["fingerprints"] = prints
    return doc
