"""Exact PAM and FastPAM1 — the deterministic oracles BanditPAM must match.

Counterpart of ``repro.core.pam.pam``: the same trajectory, the same
accept rule and the same ledger.  Both variants give identical medoids
(FastPAM1 is an algebraic rewrite of PAM's SWAP search, paper
Appendix 1.1) and differ only in the evaluations they are charged: n²
per BUILD step for both (with the d_near cache), n² (FastPAM1) or k·n²
(PAM) per SWAP step.

Every BUILD and SWAP step is one exact pass over the whole reference set
through the stats backend (``engine.exact_build_means`` /
``exact_swap_means``): the ``stream_build_g`` / ``stream_swap_g``
kernels on the card, the plain 512-column walks on the CPU.  The argmin
tie rule (flattened ``c·n + x``, lowest index) is the BanditPAM fit's,
and the accept rule is the JAX ``pam``'s: the float32 losses compared on
the host in float64, ``new < loss − 1e-7·max(1, |loss|)``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .distances import check_data, resolve_metric
from .engine import (exact_build_means, exact_swap_means, get_stats_backend,
                     medoid_cache, resolve_stats_backend, total_loss)
from .report import FitReport


# The JAX package's name for PAM's report, kept importable.
PAMResult = FitReport

def pam(data, k: int, metric: str = "l2", max_swaps: Optional[int] = None,
        fastpam1: bool = True, *, backend: str = "auto",
        device: DeviceLike = None) -> FitReport:
    """Exact PAM (FastPAM1 accounting when ``fastpam1=True``) on ``data``
    ([n, d], numpy or tensor).  ``device=None`` runs on the card."""
    dev = resolve_device(device)
    metric = resolve_metric(metric)
    data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
    if data.ndim != 2:
        raise ValueError(f"expected [n, d] data, got {tuple(data.shape)}")
    n = data.shape[0]
    k = int(k)
    if n <= k:
        raise ValueError("need n > k")
    check_data(data, metric)
    max_swaps = max_swaps if max_swaps is not None else 4 * k + 10
    be_name = resolve_stats_backend(backend, metric, dev)
    be = get_stats_backend(be_name)
    res = FitReport(medoids=np.zeros(k, np.int64), loss=np.inf, n_swaps=0,
                    converged=False, distance_evals=0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()

    # ---- BUILD ----
    dnear = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    med_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    medoids = []
    for _ in range(k):
        mu = exact_build_means(be, data, dnear, metric=metric)
        m = int(torch.argmin(torch.where(med_mask, float("inf"), mu)))
        medoids.append(m)
        med_mask[m] = True
        dnear = torch.minimum(
            dnear, be.pairwise(data[m:m + 1], data, metric=metric)[0])
    build_evals = n * n * k
    res.evals_by_phase["build"] = build_evals
    sync()
    res.wall_by_phase["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- SWAP ----
    med = torch.tensor(medoids, dtype=torch.int64, device=dev)
    loss = float(total_loss(data, med, metric=metric, backend=be_name))
    swap_evals = 0
    converged = False
    for _ in range(max_swaps):
        d1, d2, assign = medoid_cache(data, med, metric=metric,
                                      backend=be_name)
        mu = exact_swap_means(be, data, d1, d2, assign, k, metric=metric)
        best = int(torch.argmin(torch.where(med_mask.repeat(k),
                                            float("inf"), mu)))
        swap_evals += n * n if fastpam1 else k * n * n
        m_idx, x_idx = divmod(best, n)
        cand = med.clone()
        cand[m_idx] = x_idx
        new_loss = float(total_loss(data, cand, metric=metric,
                                    backend=be_name))
        if new_loss < loss - 1e-7 * max(1.0, abs(loss)):
            old = int(medoids[m_idx])
            medoids[m_idx] = x_idx
            med = cand
            med_mask[old] = False
            med_mask[x_idx] = True
            res.swap_history.append((old, x_idx, new_loss))
            loss = new_loss
        else:
            converged = True
            break
    res.evals_by_phase["swap"] = swap_evals
    sync()
    res.wall_by_phase["swap"] = time.perf_counter() - t0

    res.medoids = np.asarray(medoids, np.int64)
    res.loss = loss
    res.n_swaps = len(res.swap_history)
    res.converged = converged
    res.distance_evals = build_evals + swap_evals
    return res
