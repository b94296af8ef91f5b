"""The port's analyzer (counterpart of ``repro.analysis``), in two halves.

* **Static** (stdlib only: it imports neither torch nor jax): the AST
  rule engine (:mod:`.engine`, :mod:`.rules`, :mod:`.config`) that lints
  the port's contracts, TRC001-TRC005 (host syncs and Python loops in
  the code that runs inside the device-resident rounds and the CUDA-graph
  bodies, draws outside the threefry chain, collectives inside a stats
  backend, the parity breakers), and the import report
  (:mod:`.imports`: live, test-only and dead modules, and the LM
  quarantine), driven by ``python -m repro_torch.analysis``.
* **Runtime** (imports torch):

  - :mod:`.guard` runs a device-resident fit under ``torch.cuda``'s sync
    debug mode (``FitGuard``): any sync but ``engine.host_read``'s reads
    and ``engine.host_stage``'s input uploads raises at the call that
    made it, and the fit's reads are held to the read contract of the
    resident loop (``expected_reads``).
  - :mod:`.budgets` declares the peak-temporary bound of each budgeted
    entry point at canonical shapes and measures it on the card
    (``measure_temp_bytes``).
  - :mod:`.graph` runs every hot entry point once at canonical shapes
    under a ``TorchDispatchMode`` and holds the ops it sees and the
    hand-written kernels' launches to the graph contracts GRC000-GRC006
    (``python -m repro_torch.analysis.graph``).

The runtime modules load on first use (a module ``__getattr__``), so the
static CLI loads no torch.  Nothing in this package imports JAX.
"""

import importlib

from .config import Config, default_config
from .engine import Finding, Report, analyze_file, run

__all__ = ["Config", "FitGuard", "Finding", "Report", "analyze_file",
           "budgets", "default_config", "expected_reads", "guard",
           "guarded", "kernel_state", "run"]

_LAZY_MODULES = ("budgets", "guard", "graph")
_LAZY_FROM_GUARD = ("FitGuard", "expected_reads", "guarded", "kernel_state")


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_FROM_GUARD:
        return getattr(importlib.import_module(".guard", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
