"""OneBatchPAM (de Mathelin et al. 2025) in PyTorch (counterpart of
``repro.core.onebatch``): k-medoids against ONE fixed reference batch.

The objective is the dissimilarity to ``b`` batch points instead of all
n, so the whole search reads one resident ``[n, b]`` block
``D = d(data, data[ref])`` (the ``pairwise`` kernel on the card):

* the batch is ``jax.random.choice(PRNGKey(seed), n, (b,),
  replace=False)``, drawn with the port's threefry
  (``repro_torch.core.threefry``), so a seed gives the JAX package's
  batch;
* BUILD picks k medoids greedily, each minimising
  ``Σ_j min(D[x, j], dnear_j)`` (plain tensor math over the block);
* SWAP takes the best improving (candidate, medoid) swap per iteration,
  at most ``T = 4k + 10`` iterations, scored in the FastPAM1 form
  ``Δ(m, x) = Σ_j base_x(j) + Σ_{j∈C_m} corr_x(j)`` over the block with
  unit weights: the stats backend's cache-served SWAP statistics (the
  ``swap_g_from_cache`` kernel on the card), accepted by the repo's
  float32 rule ``Δ < −1e-7·max(1, |loss_b|)``;
* ``init=`` skips BUILD and starts SWAP from the given medoids (the
  serving layer's warm refit).

The ledger is ``n·b`` for the block plus ``n·k`` for the exact loss of
the chosen medoids over all n points (one top-2 pass); the search's
replays of the resident block are not charged, as in the JAX package.
The swap history records the BATCH objective after each swap.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import threefry
from .device import DeviceLike, resolve_device
from .distances import check_data, resolve_metric
from .engine import (get_stats_backend, host_read, resolve_stats_backend,
                     total_loss)
from .report import FitReport

__all__ = ["onebatchpam", "DEFAULT_REF_SIZE"]

# The default reference-batch size, as in the JAX package.
DEFAULT_REF_SIZE = 256


def _build(D: torch.Tensor, k: int):
    """Greedy BUILD over the block: k device indices and the medoid
    mask, with no read."""
    n, b = D.shape
    mask = torch.zeros((n,), dtype=torch.bool, device=D.device)
    dnear = torch.full((b,), float("inf"), dtype=torch.float32,
                       device=D.device)
    picks = []
    for _ in range(k):
        scores = torch.sum(torch.minimum(D, dnear[None, :]), dim=1)
        m = torch.argmin(torch.where(mask, float("inf"), scores)).view(1)
        picks.append(m)
        mask.index_fill_(0, m, True)
        dnear = torch.minimum(dnear, D.index_select(0, m)[0])
    return torch.cat(picks), mask


def _swap_step(be, D: torch.Tensor, meds: torch.Tensor, mask: torch.Tensor,
               k: int):
    """One best-improvement SWAP iteration over the block: the batch's
    medoid cache (d1, d2, assign; first-index ties), every arm's Δ, the
    best non-medoid arm (lowest flat index ``x·k + m`` on ties) and its
    accept bit, all on the device."""
    n, b = D.shape
    Dm = D.index_select(0, meds)                                # [k, b]
    a_b = torch.argmin(Dm, dim=0)
    d1 = Dm.gather(0, a_b[None])[0]
    d2 = torch.min(Dm.scatter(0, a_b[None], float("inf")), dim=0).values
    loss_b = torch.sum(d1)
    ones = torch.ones((b,), dtype=torch.float32, device=D.device)
    sums, _, _ = be.swap_stats_from_d(D, d1, d2, a_b.to(torch.int32), ones,
                                      k, None)
    delta = torch.where(mask[:, None], float("inf"),
                        sums.view(k, n).T).reshape(-1)          # [n·k]
    best = torch.argmin(delta)
    dval = delta[best]
    accept = dval < -1e-7 * torch.clamp_min(torch.abs(loss_b), 1.0)
    return best // k, best % k, loss_b + dval, accept


def onebatchpam(data, k: int, *, metric="l2", ref_size: Optional[int] = None,
                seed: int = 0, max_swaps: Optional[int] = None, init=None,
                backend: str = "auto", device: DeviceLike = None) -> FitReport:
    """Fit k medoids against one fixed reference batch of
    ``b = min(n, ref_size or DEFAULT_REF_SIZE)`` points; ``init`` (k
    distinct indices) skips BUILD.  ``loss`` is the exact full-data loss
    of the medoids.  ``device=None`` runs on the card."""
    dev = resolve_device(device)
    metric = resolve_metric(metric)
    data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
    if data.ndim != 2:
        raise ValueError(f"expected [n, d] data, got {tuple(data.shape)}")
    n, k = data.shape[0], int(k)
    if n <= k:
        raise ValueError("need n > k")
    b = min(n, int(ref_size) if ref_size is not None else DEFAULT_REF_SIZE)
    if b < 1:
        raise ValueError(f"ref_size must be >= 1, got {ref_size}")
    T = int(max_swaps) if max_swaps is not None else 4 * k + 10
    if init is not None:
        ws = np.asarray(init, np.int64).ravel()
        if ws.shape[0] != k or len(set(ws.tolist())) != k:
            raise ValueError(f"init must be {k} distinct medoid indices, "
                             f"got {ws.tolist()}")
        if ws.min() < 0 or ws.max() >= n:
            raise ValueError(f"init indices out of range [0, {n})")
    check_data(data, metric)
    be_name = resolve_stats_backend(backend, metric, dev)
    be = get_stats_backend(be_name)
    res = FitReport(medoids=np.zeros(k, np.int64), loss=np.inf)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()

    ref = threefry.choice(threefry.PRNGKey(seed), n, (b,), replace=False,
                          device=dev)
    D = be.pairwise(data, data.index_select(0, ref), metric=metric)
    if init is None:
        meds, mask = _build(D, k)
    else:
        meds = torch.tensor(ws, device=dev)
        mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        mask[meds] = True
    sync()
    res.wall_by_phase["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    done = False
    for _ in range(T):
        x, m, loss_after, accept = _swap_step(be, D, meds, mask, k)
        x_h, m_h, old_h, loss_h, acc_h = host_read(
            [x, m, meds[m], loss_after, accept], res, "swap")
        if not acc_h:
            done = True
            break
        # The recorded loss is the BATCH objective after the swap.
        res.swap_history.append((old_h, x_h, loss_h))
        meds[m_h] = x_h
        mask[old_h] = False
        mask[x_h] = True
    medoids, loss = host_read(
        [meds, total_loss(data, meds, metric=metric, backend=be_name)],
        res, "swap")
    sync()
    res.wall_by_phase["swap"] = time.perf_counter() - t0

    res.medoids = np.asarray(medoids, np.int64)
    res.loss = loss
    res.n_swaps = len(res.swap_history)
    res.converged = done
    res.evals_by_phase = {"ref_batch": n * b, "final_loss": n * k}
    res.distance_evals = n * b + n * k
    return res
