"""Back-to-back cold fits through the facade, one client in a closed
loop: call ``i`` is ``KMedoids(k, solver, metric, seed=s_i,
**params).fit(X)`` with ``X`` as numpy (its upload is part of the call,
as in a user's), ``s_i`` drawn from the run's seed and ``i``.  The mix
gives ``solver`` and ``params``."""

from __future__ import annotations

from portbench.harness import Call, FitRecord, fit_seed, reuse_of


class Job:
    def __init__(self, cfg, mix, x, labels, seed, device):
        from repro_torch.api import KMedoids
        self.x, self.seed = x, seed
        params = dict(mix.get("params", {}))
        self.reuse = reuse_of(mix)

        def make(s):
            return KMedoids(k=int(cfg["k"]), solver=mix["solver"],
                            metric=cfg["metric"], seed=s, device=device,
                            batch_size=int(cfg["batch_size"]), **params)
        self.make = make

    def call(self, i) -> Call:
        """Call ``i`` of the window (None: the warm-up)."""
        s = fit_seed(self.seed, 0) if i is None else fit_seed(self.seed, 1, i)
        r = self.make(s).fit(self.x).report_
        return Call(r, [FitRecord(None, s, r, r.labels, self.reuse)])
