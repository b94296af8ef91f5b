"""graphcheck for the port: the graph contracts of its hot entry points
(counterpart of ``repro.analysis.graph``).

tracecheck (``repro_torch.analysis``) lints the *source*; this package
audits what the hot entry points *do*: ``entrypoints`` registers each
one at canonical small shapes, ``survey`` runs it once under a
``TorchDispatchMode`` (its ops, the hand-written kernels' launches, the
transfers, collectives and casts) and keeps the golden op census keyed
by the PyTorch version and the device type at
``tests/fixtures/graphs_torch.json``, and ``rules`` holds the runs to
GRC000–GRC006 (the memory budgets are ``repro_torch.analysis.budgets``,
measured on the card).

CLI: ``python -m repro_torch.analysis.graph --device {cpu,cuda}`` (see
``--help``).  This package imports torch, never JAX.
"""

from .rules import ALL_RULES, Finding, Report, RULE_DOCS, analyze

__all__ = ["ALL_RULES", "RULE_DOCS", "Finding", "Report", "analyze"]
