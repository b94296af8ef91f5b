"""BanditPAM: BUILD + SWAP driven by Algorithm 1, in PyTorch.

Counterpart of ``repro.core.banditpam.BanditPAM.fit`` without a distance
cache (``reuse="none"``, ``cache_cols=0``: the JAX package's
``FitContext(mode="none")``), for every sampling mode and baseline:

* BUILD (Eq. 6): k adaptive searches over the candidate points, each
  against ``d_near`` (the nearest chosen medoid per reference point,
  updated after each pick through the backend's pairwise tile);
  δ = 1/(1000·n) by default.
* SWAP (Eq. 7 + the FastPAM1 form of Eq. 12): each iteration refreshes
  the medoid cache (d1, d2, assign) with one top-2 pass, searches the k·n
  (medoid, candidate) arms (δ = 1/(1000·k·n)), scores the winner's swap
  with the exact loss and accepts it by the JAX package's float32 rule
  ``new < prev − 1e-7·max(1, |prev|)``, computed on the device; at most
  ``4k + 10`` iterations.  ``swap_early_stop`` ends a search once no
  surviving arm can be an improving swap.
* ``sampling="replacement"`` draws i.i.d. batches and resolves a search
  that ends with several survivors exactly (``engine.exact_build_means``
  / ``exact_swap_means``: one streaming pass, the ``stream_build_g`` /
  ``stream_swap_g`` kernels on the card); ``swap_exact_fallbacks``
  counts the SWAP searches that did.  ``baseline="leader"`` adds the
  differenced kill rule (``adaptive.py``).
* The ledger is the paper's: each round pays #active arms × B in BUILD
  and #distinct active candidates × B in SWAP, an exact fallback
  #survivors (distinct candidates) × n; BUILD adds n·k for the d_near
  updates, every SWAP iteration 2·n·k for the cache and the loss.

The port has one host-driven fit loop (one device read per bandit
round), so ``fused=False`` (the JAX package's stepped fit loop) runs the
same code and gives the identical report.

Random draws: every search takes its reference permutation, or in
replacement mode its per-round batches, from a layout source
(``repro_torch.core.rng``).  The default draws from a ``torch.Generator``
seeded with ``seed``, so the same seed does NOT give the JAX package's
medoids; pass ``layouts=`` built by ``repro_torch.convert`` from the JAX
chain's draws to replay a JAX fit exactly.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .adaptive import adaptive_search, log_term_f32
from .device import DeviceLike, resolve_device
from .distances import resolve_metric
from .engine import (exact_build_means, exact_swap_means, get_stats_backend,
                     medoid_cache, resolve_stats_backend, total_loss)
from .report import FitReport
from . import rng as _rng

__all__ = ["BanditPAM", "FitReport", "medoid_cache", "total_loss"]


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP {item})")


class BanditPAM:
    """k-medoids via adaptive sampling; same medoids as PAM w.h.p.

    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` for the plain path.  ``backend`` is ``"auto"``,
    ``"cuda"``, ``"torch"`` or any registered stats backend.  The knobs of
    the JAX estimator that this package does not port yet raise
    ``NotImplementedError`` naming their ROADMAP item.
    """

    def __init__(self, k: int, metric: str = "l2", batch_size: int = 100,
                 delta: Optional[float] = None,
                 max_swaps: Optional[int] = None, seed: int = 0,
                 sampling: str = "permutation", baseline: str = "none",
                 swap_early_stop: bool = False, cache_cols: int = 0,
                 reuse: str = "none", cache_width: Optional[int] = None,
                 backend: str = "auto", fused: bool = True,
                 device: DeviceLike = None):
        if sampling not in ("permutation", "replacement"):
            raise ValueError(f"unknown sampling mode {sampling!r}")
        if baseline not in ("none", "leader"):
            raise ValueError(f"unknown baseline mode {baseline!r}")
        if reuse not in ("none", "pic"):
            raise ValueError(f"unknown reuse mode {reuse!r}")
        if reuse == "pic" or cache_width is not None:
            raise _not_ported('reuse="pic"', "A9")
        if cache_cols > 0:
            raise _not_ported("cache_cols > 0 (the warm block)", "A9")
        self.k = int(k)
        self.metric = resolve_metric(metric)
        self.batch_size = int(batch_size)
        self.delta = delta
        self.max_swaps = max_swaps if max_swaps is not None else 4 * self.k + 10
        self.seed = seed
        self.sampling = sampling
        self.baseline = baseline
        self.swap_early_stop = bool(swap_early_stop)
        self.backend = backend
        self.device = device

    def _search_kw(self, layouts, phase: str, s: int, n: int, dev) -> dict:
        """The batch source of search ``s`` of ``phase``: its permutation,
        or its per-round draws; and the baseline."""
        kw = dict(baseline=self.baseline)
        if self.sampling == "permutation":
            perm = getattr(layouts, f"{phase}_perm")(s, n)
            kw["perm"] = _rng.as_device_index(perm, dev)
        else:
            draw = getattr(layouts, f"{phase}_draw")
            kw["draw"] = lambda rnd: _rng.as_device_index(
                draw(s, rnd, n, self.batch_size), dev)
        return kw

    # -- BUILD ----------------------------------------------------------
    def _build(self, data, be_name, layouts, res: FitReport):
        n = data.shape[0]
        be = get_stats_backend(be_name)
        dev = data.device
        delta = self.delta if self.delta is not None else 1.0 / (1000.0 * n)
        log_term = log_term_f32(delta, dev)
        dnear = torch.full((n,), float("inf"), dtype=torch.float32,
                           device=dev)
        med_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        medoids, evals = [], 0
        for i in range(self.k):
            def stats_fn(ref_idx, w, lead):
                return be.build_stats(data, ref_idx, dnear[ref_idx], w, lead,
                                      metric=self.metric)

            def exact_fn():
                return exact_build_means(be, data, dnear, metric=self.metric)

            sr = adaptive_search(
                stats_fn=stats_fn, exact_fn=exact_fn,
                n_arms=n, n_ref=n, batch_size=self.batch_size,
                log_term=log_term, active_init=torch.logical_not(med_mask),
                **self._search_kw(layouts, "build", i, n, dev))
            m = sr.best
            medoids.append(m)
            med_mask[m] = True
            dnear = torch.minimum(
                dnear, be.pairwise(data[m:m + 1], data, metric=self.metric)[0])
            res.build_rounds.append(sr.rounds)
            evals += sr.n_evals
        res.evals_by_phase["build"] = evals + n * self.k
        return medoids, med_mask

    # -- SWAP -----------------------------------------------------------
    def _swap(self, data, medoids, med_mask, be_name, layouts,
              res: FitReport):
        n = data.shape[0]
        k = self.k
        be = get_stats_backend(be_name)
        dev = data.device
        delta = (self.delta if self.delta is not None
                 else 1.0 / (1000.0 * k * n))
        log_term = log_term_f32(delta, dev)
        med_t = torch.tensor(medoids, dtype=torch.int64, device=dev)
        prev_loss = total_loss(data, med_t, metric=self.metric,
                               backend=be_name)
        loss = float(prev_loss.item())
        converged = False
        swap_evals = 0

        def count_fn(active):
            # FastPAM1: one distance per (x, y) pair serves all k arms (·, x).
            return torch.sum(torch.any(active.view(k, n), dim=0),
                             dtype=torch.int64)

        for t in range(self.max_swaps):
            d1, d2, assign = medoid_cache(data, med_t, metric=self.metric,
                                          backend=be_name)

            def stats_fn(ref_idx, w, lead):
                return be.swap_stats(data, ref_idx, d1[ref_idx], d2[ref_idx],
                                     assign[ref_idx], w, k, lead,
                                     metric=self.metric)

            def exact_fn():
                return exact_swap_means(be, data, d1, d2, assign, k,
                                        metric=self.metric)

            sr = adaptive_search(
                stats_fn=stats_fn, exact_fn=exact_fn,
                n_arms=k * n, n_ref=n, batch_size=self.batch_size,
                log_term=log_term,
                active_init=torch.logical_not(med_mask).repeat(k),
                count_fn=count_fn, stop_when_positive=self.swap_early_stop,
                **self._search_kw(layouts, "swap", t, n, dev))
            res.swap_exact_fallbacks += int(sr.used_exact)
            m_idx, x_idx = divmod(sr.best, n)
            cand = med_t.clone()
            cand[m_idx] = x_idx
            new_loss = total_loss(data, cand, metric=self.metric,
                                  backend=be_name)
            # The JAX package's accept rule, float32 on the device.
            accept = new_loss < prev_loss - 1e-7 * torch.clamp_min(
                torch.abs(prev_loss), 1.0)
            new_loss_h, accept_h = torch.stack(
                [new_loss.double(), accept.double()]).tolist()
            swap_evals += 2 * n * k + sr.n_evals
            if not accept_h:
                converged = True
                break
            old = medoids[m_idx]
            medoids[m_idx] = x_idx
            med_mask[old] = False
            med_mask[x_idx] = True
            med_t = cand
            res.swap_history.append((old, x_idx, float(new_loss_h)))
            loss = float(new_loss_h)
            prev_loss = new_loss
        res.evals_by_phase["swap"] = swap_evals
        return medoids, loss, converged

    # -- public ----------------------------------------------------------
    def fit(self, data, warm_start=None, layouts=None) -> FitReport:
        """Fit medoids on ``data`` ([n, d], numpy or tensor).

        ``layouts`` is the source of the per-search reference
        permutations or replacement draws (``repro_torch.core.rng``); by
        default a ``torch.Generator`` seeded with ``self.seed`` on the
        fit's device.
        """
        if warm_start is not None:
            raise _not_ported("warm_start", "A11")
        dev = resolve_device(self.device)
        data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
        if data.ndim != 2:
            raise ValueError(f"expected [n, d] data, got {tuple(data.shape)}")
        n = data.shape[0]
        if n <= self.k:
            raise ValueError("need n > k")
        be_name = resolve_stats_backend(self.backend, self.metric, dev)
        if layouts is None:
            layouts = _rng.from_generator(self.seed, dev)
        res = FitReport(medoids=np.zeros(self.k, np.int64), loss=np.inf,
                        n_swaps=0, converged=False, distance_evals=0)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        medoids, med_mask = self._build(data, be_name, layouts, res)
        sync()
        res.wall_by_phase["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        medoids, loss, converged = self._swap(data, medoids, med_mask,
                                              be_name, layouts, res)
        sync()
        res.wall_by_phase["swap"] = time.perf_counter() - t0
        res.medoids = np.asarray(medoids, np.int64)
        res.loss = loss
        res.n_swaps = len(res.swap_history)
        res.converged = converged
        res.distance_evals = sum(v for ph, v in res.evals_by_phase.items()
                                 if not ph.endswith("_cached"))
        res.cached_evals = 0
        return res

    def fit_batch(self, datasets, seeds=None):
        raise _not_ported("fit_batch", "A10")
