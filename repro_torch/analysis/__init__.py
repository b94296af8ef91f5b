"""The runtime half of the analyzer, for the port (counterpart of
``repro.analysis``'s runtime modules).

* :mod:`.guard` runs a device-resident fit under ``torch.cuda``'s sync
  debug mode (``FitGuard``): any sync but ``engine.host_read``'s reads
  and ``engine.host_stage``'s input uploads raises at the call that made
  it, and the fit's reads are held to the read contract of the resident
  loop (``expected_reads``).
* :mod:`.budgets` declares the peak-temporary bound of each budgeted
  entry point at canonical shapes and measures it on the card
  (``measure_temp_bytes``).

The JAX package's static half (the AST rules, the HLO rules of its
``graph`` subpackage and the import report) checks JAX programs and has
no counterpart here.  Nothing in this package imports JAX.
"""

from . import budgets, guard
from .guard import FitGuard, expected_reads, guarded, kernel_state

__all__ = ["FitGuard", "budgets", "expected_reads", "guard", "guarded",
           "kernel_state"]
