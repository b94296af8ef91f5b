"""One run of an entry point, surveyed: its ops, the hand-written kernels'
launches, and the golden artifact (counterpart of
``repro.analysis.graph.fingerprint``).

The JAX package walks a traced jaxpr; an eager PyTorch program has none,
so the port runs the entry point once, for real, at the registry's
canonical small shapes, under a ``TorchDispatchMode`` that sees every
ATen op it dispatches (:class:`Survey`):

* ``census``: op name (``aten.mm.default``) -> count, plus
  ``kernel:<name>`` -> launches of each hand-written kernel over the call
  (the deltas of ``kernels.ops.launch_counts()``: the kernels are loaded
  with ``ctypes``, so the dispatcher sees their outputs' ``aten.empty``
  but not their launches; a CUDA graph's replay is counted through the
  same counters);
* ``eqn_sig``: the ``(op, output shapes and dtypes)`` sequence, the hash
  substrate;
* ``big_outs``: ``(op, shape)`` of every output with two axes or more;
* ``converts``: ``(from, to)`` of every float-to-float cast
  (``_to_copy`` to another dtype, ``copy_`` across dtypes);
* ``transfers``: ``aten._local_scalar_dense`` (a ``.item()``, a
  ``bool()`` or ``int()`` of a tensor) and every copy that crosses
  devices, but the copies made inside ``engine.host_read`` /
  ``host_stage`` / ``phase_sync`` (they all enter
  ``engine.syncs_allowed``: the sanctioned spans) and the uploads from
  pinned memory without a wait (``pic_cache.to_device``: a host table
  placed on the card, the counterpart of the JAX package's constant
  staging, which is not a round trip);
* ``collectives``: the ``c10d.*`` and ``_c10d_functional.*`` ops.

An eager census grows with the rounds the run takes; at fixed seeds and
one intra-op thread (set for the run on the CPU) it is deterministic.
The census differs across PyTorch versions and devices, so the goldens
are keyed by both: ``"<torch.__version__>|<device type>"``.  A runner
whose key has no golden gets a note, not a finding.  The goldens live at
``tests/fixtures/graphs_torch.json``; regenerate with ``REGEN_GOLDEN=1
python -m repro_torch.analysis.graph --device {cpu,cuda}`` (merges the
running key's entries and keeps the other keys').
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Survey", "survey", "fingerprint", "diff_fingerprints",
           "load_golden", "merge_golden", "golden_for_key", "golden_key",
           "default_golden_path", "dump_golden", "GOLDEN_ENV"]

GOLDEN_ENV = "REGEN_GOLDEN"
_FLOAT_BITS = {torch.float64: 64, torch.float32: 32, torch.float16: 16,
               torch.bfloat16: 16}
_COLLECTIVE_NAMESPACES = ("c10d.", "_c10d_functional.")
# Ops whose output is a whole new copy of an input (GRC005 reads them).
COPY_OPS = frozenset({"clone", "_to_copy", "cat", "stack", "index_copy",
                      "index_put", "slice_scatter", "select_scatter",
                      "scatter", "masked_scatter", "copy", "empty_like",
                      "zeros_like", "new_empty", "new_zeros"})


class Survey:
    """Everything one surveyed run collects (module docstring)."""

    def __init__(self) -> None:
        self.census: Dict[str, int] = {}
        self.eqn_sig: List[Tuple[str, str]] = []
        self.big_outs: List[Tuple[str, Tuple[int, ...]]] = []
        self.converts: List[Tuple[str, str]] = []
        self.transfers: List[Tuple[str, str]] = []
        self.collectives: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        # (op, shape, dtype, storage address) of every copy-class output
        self.copies: List[Tuple[str, Tuple[int, ...], str, int]] = []
        self.in_avals: List[str] = []
        self.out_avals: List[str] = []


def _aval(t: torch.Tensor) -> str:
    return (f"{str(t.dtype).replace('torch.', '')}"
            f"[{','.join(str(s) for s in t.shape)}]")


def _tensors(tree) -> List[torch.Tensor]:
    out, stack = [], [tree]
    while stack:
        v = stack.pop(0)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            stack[:0] = list(v)
        elif isinstance(v, dict):
            stack[:0] = list(v.values())
    return out


class _Spans:
    """Depth of the sanctioned spans: ``engine.syncs_allowed`` wrapped,
    wherever the package bound it, for the run (``host_read``,
    ``host_stage`` and ``phase_sync`` all enter it)."""

    def __init__(self) -> None:
        self.depth = 0

    @contextlib.contextmanager
    def patched(self):
        from ...core import engine
        orig = engine.syncs_allowed
        spans = self

        @contextlib.contextmanager
        def counted(device):
            spans.depth += 1
            try:
                with orig(device):
                    yield
            finally:
                spans.depth -= 1

        bound = [(m, name) for m in list(sys.modules.values())
                 if getattr(m, "__name__", "").startswith("repro_torch")
                 for name, v in list(vars(m).items()) if v is orig]
        for m, name in bound:
            setattr(m, name, counted)
        try:
            yield
        finally:
            for m, name in bound:
                setattr(m, name, orig)


class _Recorder(TorchDispatchMode):
    def __init__(self, sv: Survey, spans: _Spans) -> None:
        super().__init__()
        self.sv, self.spans = sv, spans

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(str(func), func, args, kwargs, out)
        return out

    def _record(self, name, func, args, kwargs, out) -> None:
        sv = self.sv
        sv.census[name] = sv.census.get(name, 0) + 1
        outs = _tensors(out)
        packet = func._overloadpacket.__name__
        for t in outs:
            sv.eqn_sig.append((name, _aval(t)))
            if packet in COPY_OPS:
                sv.copies.append((name, tuple(t.shape), str(t.dtype),
                                  t.untyped_storage().data_ptr()))
            if t.dim() >= 2:
                sv.big_outs.append((name, tuple(int(s) for s in t.shape)))
        if name.startswith(_COLLECTIVE_NAMESPACES):
            sv.collectives[name] = sv.collectives.get(name, 0) + 1
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if packet == "copy_" and len(args) > 1 and isinstance(
                args[1], torch.Tensor):
            dst, src = args[0], args[1]
        elif packet == "_to_copy" and outs:
            dst = outs[0]
        else:
            dst = None
        if dst is not None and src is not None:
            if dst.dtype != src.dtype and src.dtype in _FLOAT_BITS \
                    and dst.dtype in _FLOAT_BITS:
                sv.converts.append((str(src.dtype).replace("torch.", ""),
                                    str(dst.dtype).replace("torch.", "")))
            if dst.device != src.device and self.spans.depth == 0:
                staged = (src.device.type == "cpu" and src.is_pinned()
                          and bool(kwargs.get("non_blocking")
                                   or (len(args) > 2 and args[2])))
                if not staged:
                    sv.transfers.append(
                        (name, f"{src.device.type}->{dst.device.type} "
                               f"{_aval(src)}"))
        if packet == "_local_scalar_dense" and self.spans.depth == 0:
            sv.transfers.append((name, f"{src.device.type} {_aval(src)}"
                                 if src is not None else ""))


@contextlib.contextmanager
def _one_thread(device: torch.device):
    """One intra-op thread on the CPU for the run: the census must not
    depend on the host's core count (a reduction's order may)."""
    if device.type != "cpu":
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def survey(call: Callable[[], Any], device=None,
           inputs: Tuple[torch.Tensor, ...] = ()) -> Tuple[Survey, Any]:
    """Run ``call()`` once under the recorder; returns the survey and the
    call's result.  ``inputs`` (the entry point's tensor arguments) only
    enter the fingerprint's input avals."""
    from ...kernels import ops
    dev = torch.device("cpu" if device is None else device)
    sv = Survey()
    spans = _Spans()
    sv.in_avals = [_aval(t) for t in inputs]
    with _one_thread(dev), spans.patched():
        before = ops.launch_counts()
        with _Recorder(sv, spans):
            result = call()
        after = ops.launch_counts()
    sv.launches = {k: after[k] - before[k] for k in sorted(after)
                   if after[k] != before[k]}
    for k, v in sv.launches.items():
        sv.census[f"kernel:{k}"] = v
    sv.out_avals = [_aval(t) for t in _tensors(result)]
    return sv, result


def fingerprint(sv: Survey) -> Dict:
    """The fingerprint document of one surveyed run."""
    h = hashlib.sha256()
    for name, aval in sv.eqn_sig:
        h.update(name.encode())
        h.update(aval.encode())
    for k, v in sorted(sv.launches.items()):
        h.update(f"kernel:{k}={v}".encode())
    for a in sv.in_avals + sv.out_avals:
        h.update(a.encode())
    return {
        "census": dict(sorted(sv.census.items())),
        "in": list(sv.in_avals),
        "out": list(sv.out_avals),
        "hash": h.hexdigest()[:16],
    }


def diff_fingerprints(old: Dict, new: Dict) -> str:
    """Op-level diff between two fingerprints, human-readable."""
    lines: List[str] = []
    oc, nc = old.get("census", {}), new.get("census", {})
    for op in sorted(set(oc) | set(nc)):
        a, b = oc.get(op, 0), nc.get(op, 0)
        if a != b:
            lines.append(f"    {op}: {a} -> {b} ({b - a:+d})")
    for field in ("in", "out"):
        if old.get(field) != new.get(field):
            lines.append(f"    {field} avals: {old.get(field)} -> "
                         f"{new.get(field)}")
    if not lines and old.get("hash") != new.get("hash"):
        lines.append(
            "    same census, different op sequence/avals "
            f"(hash {old.get('hash')} -> {new.get('hash')})")
    return "\n".join(lines)


# -- golden artifact io -----------------------------------------------------

def golden_key(device=None) -> str:
    """The running key: the PyTorch version and the device type."""
    dev = torch.device("cpu" if device is None else device)
    return f"{torch.__version__}|{dev.type}"


def default_golden_path() -> Optional[str]:
    """``tests/fixtures/graphs_torch.json`` at the repo root, if the
    package runs from a checkout (``<root>/repro_torch/analysis/graph/``);
    None elsewhere, and the CLI notes it instead of drift findings."""
    root = os.path.abspath(__file__)
    for _ in range(4):
        root = os.path.dirname(root)
    cand = os.path.join(root, "tests", "fixtures", "graphs_torch.json")
    return cand if os.path.isdir(os.path.dirname(cand)) else None


def load_golden(path: str) -> Dict:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("tool") != "graphcheck":
        raise ValueError(f"{path} is not a graphcheck golden file")
    return doc


def golden_for_key(doc: Optional[Dict], key: str) -> Optional[Dict]:
    """The committed fingerprints for ``key``, if any."""
    if doc is None:
        return None
    return doc.get("goldens", {}).get(key)


def merge_golden(doc: Optional[Dict], fingerprints: Dict[str, Dict],
                 key: str) -> Dict:
    """Merge fingerprints under ``key``, keeping every other key's entries
    as they were."""
    out = {"tool": "graphcheck", "version": 1,
           "goldens": dict((doc or {}).get("goldens", {}))}
    out["goldens"][key] = {k: fingerprints[k] for k in sorted(fingerprints)}
    return out


def dump_golden(doc: Dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
