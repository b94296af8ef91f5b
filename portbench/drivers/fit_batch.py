"""Back-to-back batches of independent fits, one client in a closed
loop: the rows are split by their mixture component (a cell type) into
one lane each, and call ``i`` is ``KMedoids(k, solver, metric,
**params).fit_batch(lanes, seeds)`` with lane ``l``'s seed drawn from the
run's seed, ``i`` and ``l``.  A call of L lanes is L fits."""

from __future__ import annotations

import numpy as np

from portbench.harness import Call, FitRecord, fit_seed, reuse_of


class Job:
    def __init__(self, cfg, mix, x, labels, seed, device):
        from repro_torch.api import KMedoids
        self.seed = seed
        self.rows = [np.flatnonzero(labels == c) for c in np.unique(labels)]
        self.lanes = [np.ascontiguousarray(x[r]) for r in self.rows]
        params = dict(mix.get("params", {}))
        self.reuse = reuse_of(mix)
        self.est = KMedoids(k=int(cfg["k"]), solver=mix["solver"],
                            metric=cfg["metric"], device=device,
                            batch_size=int(cfg["batch_size"]), **params)

    def call(self, i) -> Call:
        """Call ``i`` of the window (None: the warm-up)."""
        seeds = [fit_seed(self.seed, 0, lane) if i is None
                 else fit_seed(self.seed, 1, i, lane)
                 for lane in range(len(self.lanes))]
        rep = self.est.fit_batch(self.lanes, seeds=seeds)
        return Call(rep, [FitRecord(rows, s, r, rep.labels[j, :len(rows)],
                                    self.reuse)
                          for j, (rows, s, r) in enumerate(
                              zip(self.rows, seeds, rep.reports))])
