"""The fit report, field for field the JAX package's ``FitReport``.

Ledger semantics:

* ``distance_evals`` — FRESH pairwise dissimilarity evaluations the
  algorithm paid for, exactly as the paper counts them.
* ``cached_evals`` — evaluations served from a distance cache: the
  ``reuse="pic"`` rounds replayed from the ring and the carried-moment
  repairs (zero without the ring).
* ``evals_by_phase`` — the itemised split: ``build``, ``swap`` and, with
  a cache, ``cache_warm`` (the warm block, fresh), ``build_cached`` and
  ``swap_cached``; the keys ending in ``_cached`` make up
  ``cached_evals``, all others ``distance_evals``.

The port keeps every count as a Python int (the device tallies are
int64).  The JAX package's per-search count is uint32 and would wrap
past 2**32 evaluations in one search at large n; the port's does not.

``wall_by_phase`` holds seconds per phase, measured on the host around
work that ends in a device synchronisation.  ``host_reads_by_phase``
counts the driver's device-to-host reads per phase (``build``, ``swap``),
each one ``engine.host_read`` that waits for the device, which the
port's ``analysis.FitGuard`` holds to the resident loop's read contract
(``analysis.guard.expected_reads``), as the JAX package's holds its
dispatches.
``dispatches_by_phase`` has no torch meaning and stays empty.

:class:`BatchFitReport` is ``fit_batch``'s result: one ``FitReport`` a
fit and the batch's own counts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class FitReport:
    medoids: np.ndarray
    loss: float
    n_swaps: int = 0
    converged: bool = False
    distance_evals: int = 0
    evals_by_phase: Dict[str, int] = field(default_factory=dict)
    swap_history: List[Tuple[int, int, float]] = field(default_factory=list)
    build_rounds: List[int] = field(default_factory=list)
    swap_exact_fallbacks: int = 0
    cached_evals: int = 0
    labels: Optional[np.ndarray] = None
    solver: str = ""
    metric: str = ""
    wall_by_phase: Dict[str, float] = field(default_factory=dict)
    dispatches_by_phase: Dict[str, int] = field(default_factory=dict)
    host_reads_by_phase: Dict[str, int] = field(default_factory=dict)

    def ledger(self) -> Dict[str, object]:
        """The fresh/cached distance-evaluation ledger as one dict."""
        return {
            "fresh": int(self.distance_evals),
            "cached": int(self.cached_evals),
            "by_phase": {k: int(v) for k, v in self.evals_by_phase.items()},
        }


@dataclass
class BatchFitReport:
    """The result of one batched multi-fit (``BanditPAM.fit_batch`` /
    ``KMedoids.fit_batch``), field for field the JAX package's.

    ``reports`` holds one full :class:`FitReport` a fit (medoids, loss,
    swap history, build rounds and the fresh/cached ledger), equal to the
    single fit's for the same seed; a lane has no walls or reads of its
    own, so their ``wall_by_phase`` and ``host_reads_by_phase`` are
    empty.  The batch-level fields are the whole batch's:

    * ``dispatches_by_phase``: the batched round launches per phase.  A
      round of the lockstep batch is ONE ``build_g`` or ``swap_g`` launch
      on the card for every lane (``reuse="pic"``: one lane ``pairwise``
      launch for the fresh blocks and the served statistics; one loop
      over the lanes on the plain backend), rounds enqueued past every
      lane's stop included; the count does not grow with the batch.
    * ``host_reads_by_phase``: the batch's device-to-host reads per phase
      (``engine.host_read``).
    * ``wall_by_phase``: seconds per phase for the whole batch, on the
      host around work that ends in a device synchronisation.
    * ``medoids`` / ``loss``: the stacked ``[B, k]`` / ``[B]`` views.
    * ``labels``: stacked ``[B, n_max]`` in-sample assignments (filled by
      the facade; 0 past a fit's ``n_valid``).
    * ``n_valid``: each fit's n.

    The container is sequence-like: ``len(batch)``, ``batch[i]`` and
    iteration give the per-fit reports.
    """

    reports: List[FitReport]
    medoids: np.ndarray                     # [B, k]
    loss: np.ndarray                        # [B]
    n_valid: Optional[np.ndarray] = None    # [B] logical n per fit
    labels: Optional[np.ndarray] = None     # [B, n_max]
    solver: str = ""
    metric: str = ""
    wall_by_phase: Dict[str, float] = field(default_factory=dict)
    dispatches_by_phase: Dict[str, int] = field(default_factory=dict)
    host_reads_by_phase: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.reports)

    def __getitem__(self, i: int) -> FitReport:
        return self.reports[i]

    def __iter__(self) -> Iterator[FitReport]:
        return iter(self.reports)
