"""The paper's comparison baselines (Fig. 1a: CLARANS, Voronoi iteration,
CLARA) and FasterPAM, in PyTorch (counterpart of
``repro.core.baselines``): the same trajectories, accept rules, draws and
ledgers.

Each solver draws with ``np.random.default_rng(seed)`` exactly as the JAX
package does, so the same seed gives the same draws in both packages.
Each takes ``backend=`` (``"auto"``, ``"cuda"``, ``"torch"``) and
``device=`` as :func:`repro_torch.core.pam.pam` does; every medoid cache
and loss is one top-2 pass through the backend (the ``top2`` kernel on
the card).

* :func:`fasterpam` (Schubert & Rousseeuw): every improving swap is taken
  the moment the sweep over the candidates finds it.  ``Δ(m, x) = Σ_y
  base_x(y) + Σ_{y∈C_m} corr_x(y)`` scores all k removals of candidate x.
  Two routes give the same decisions and ledger: one candidate at a time
  from its distance row (the JAX package's way; the default on
  ``"torch"``), or a block of candidates at once from the streaming SWAP
  statistics over all n references with weight 1 (the ``stream_swap_g``
  kernel on the card, the default on ``"cuda"``), scanned in sweep order
  up to the first improving non-medoid, where the block is cut short and
  the next one starts after the swap.  Candidates scored past an accepted
  swap are not charged; one read per block replaces one per candidate.
* :func:`voronoi_iteration` (Park & Jun): assign, then re-elect each
  cluster's medoid from the ``[n, k]`` cost ``Σ_{y∈C_c} d(x, y)``, built
  from column tiles (the ``pairwise`` kernel on the card, then a product
  with the one-hot) so the ``[n, n]`` block never exists.
* :func:`clarans` (Ng & Han): random neighbours of the current medoid
  set, each scored by its exact loss.
* :func:`clara` (Kaufman & Rousseeuw): PAM on subsamples, each scored on
  all n points.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .distances import check_data, full_fp32, resolve_metric
from .engine import (_swap_terms, get_stats_backend, host_read, medoid_cache,
                     resolve_stats_backend, total_loss)
from .pam import pam
from .report import FitReport

# Alias of the unified report type, as in the JAX package.
BaselineResult = FitReport

# FasterPAM's candidate block on the card: 256 row tiles of 128, about
# one wave of the streaming SWAP kernel on the H100's 264 block slots
# (each tile walks all n references, so a smaller block costs the same).
FASTERPAM_BLOCK = 256 * 128
# Voronoi's reference columns per pairwise tile (983 MB at n = 60,000).
VORONOI_TILE = 4096


# The JAX package's name for the baselines' report, kept importable.
BaselineResult = FitReport

def _setup(data, metric, backend: str, device: DeviceLike):
    dev = resolve_device(device)
    metric = resolve_metric(metric)
    data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
    if data.ndim != 2:
        raise ValueError(f"expected [n, d] data, got {tuple(data.shape)}")
    check_data(data, metric)
    return data, metric, resolve_stats_backend(backend, metric, dev), dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# FasterPAM — eager multi-medoid swaps
# ---------------------------------------------------------------------------

def _row_delta(be, data, x: int, d1, d2, assign, k: int, metric: str):
    """Δ(m, x) for every medoid slot m from x's distance row: the
    segment sum of the correction terms over the assignment."""
    dx = be.pairwise(data[x:x + 1], data, metric=metric)
    base, corr = _swap_terms(dx, d1, d2)
    seg = torch.zeros((k,), dtype=torch.float32, device=data.device)
    seg.index_add_(0, assign.long(), corr[0])
    return torch.sum(base) + seg


def fasterpam(data, k: int, metric="l2", max_steps: Optional[int] = None,
              seed: int = 0, init=None, *, backend: str = "auto",
              device: DeviceLike = None) -> FitReport:
    """Eager-swap exact k-medoids: sweep the candidates in index order
    (cyclically from 0), take each improving swap at once, stop after a
    full sweep without one (or ``max_steps`` candidates, default 50n).
    ``init`` seeds the medoids, default a uniform draw.  On ``"torch"``
    one candidate is scored at a time; on ``"cuda"``
    :data:`FASTERPAM_BLOCK` at a time through the streaming SWAP
    statistics.  The ledger is n per candidate scored plus n·k per
    medoid-cache rebuild."""
    data, metric, be_name, dev = _setup(data, metric, backend, device)
    block = FASTERPAM_BLOCK if be_name == "cuda" else 0
    return _fasterpam_sweep(data, k, metric, be_name, dev, block,
                            max_steps, seed, init)


def _fasterpam_sweep(data: torch.Tensor, k: int, metric: str, be_name: str,
                     dev: torch.device, block: int,
                     max_steps: Optional[int] = None, seed: int = 0,
                     init=None) -> FitReport:
    """:func:`fasterpam`'s sweep on set-up data: ``block=0`` scores one
    candidate at a time from its distance row, ``block=b`` scores ``b``
    at a time through the backend's streaming SWAP statistics."""
    be = get_stats_backend(be_name)
    n, k = data.shape[0], int(k)
    if init is None:
        rng = np.random.default_rng(seed)
        medoids = rng.choice(n, size=k, replace=False).astype(np.int64)
    else:
        medoids = np.asarray(init, np.int64).ravel()
    res = FitReport(medoids=medoids, loss=np.inf)
    _sync(dev)
    t0 = time.perf_counter()
    med = torch.tensor(medoids, device=dev)
    d1, d2, assign = medoid_cache(data, med, metric=metric, backend=be_name)
    evals = n * k
    (loss,) = host_read([torch.sum(d1)], res, "swap")
    max_steps = max_steps if max_steps is not None else 50 * n
    med_set = set(medoids.tolist())
    med_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    med_mask[med] = True
    since_improved, steps, x, n_swaps = 0, 0, 0, 0
    while since_improved < n and steps < max_steps:
        thr = -1e-7 * max(1.0, abs(loss))
        if block <= 0:
            span = 1
            if x in med_set:
                hit = None
            else:
                delta = _row_delta(be, data, x, d1, d2, assign, k, metric)
                m_idx = torch.argmin(delta)
                m_h, dval = host_read([m_idx, delta[m_idx]], res, "swap")
                hit = (0, m_h) if dval < thr else None
        else:
            # Positions x, x+1, ... of the sweep, no further than the
            # stop; medoids among them are scored and never accepted.
            span = min(block, n - since_improved, max_steps - steps)
            pos = (x + torch.arange(span, device=dev)) % n
            sums = be.stream_swap_sums(data, d1, d2, assign, k,
                                       metric=metric, rows=pos).view(k, span)
            m_all = torch.argmin(sums, dim=0)           # first-index ties
            dmin = sums.gather(0, m_all[None])[0]
            ok = (dmin.double() < thr) & ~med_mask[pos]
            first = torch.argmax(ok.to(torch.int32))
            found, j, m_h = host_read([torch.any(ok), first, m_all[first]],
                                      res, "swap")
            hit = (j, m_h) if found else None
        # Every position up to the accepted one (or the whole span) was
        # stepped over; the non-medoids among them were scored.
        stepped = span if hit is None else hit[0] + 1
        evals += n * (stepped - sum(1 for mm in med_set
                                    if (mm - x) % n < stepped))
        steps += stepped
        x_acc = (x + stepped - 1) % n
        x = (x + stepped) % n
        if hit is None:
            since_improved += stepped
            continue
        m_idx = hit[1]
        old = int(medoids[m_idx])
        med_set.discard(old)
        med_set.add(x_acc)
        medoids[m_idx] = x_acc
        med[m_idx] = x_acc
        med_mask[old] = False
        med_mask[x_acc] = True
        d1, d2, assign = medoid_cache(data, med, metric=metric,
                                      backend=be_name)
        evals += n * k
        (loss,) = host_read([torch.sum(d1)], res, "swap")
        since_improved = 0
        n_swaps += 1
    _sync(dev)
    res.wall_by_phase["swap"] = time.perf_counter() - t0
    res.medoids = medoids
    res.loss = loss
    res.distance_evals = evals
    res.n_swaps = n_swaps
    res.converged = since_improved >= n
    res.evals_by_phase = {"swap": evals}
    return res


# ---------------------------------------------------------------------------
# Voronoi iteration — k-means-style alternation
# ---------------------------------------------------------------------------

def _voronoi_update(be, data, med: torch.Tensor, k: int, metric: str,
                    be_name: str) -> torch.Tensor:
    """Reassign the points (first-index ties), then re-elect each
    cluster's medoid: the member x of least ``Σ_{y∈C_c} d(x, y)``.  The
    cost accumulates over column tiles of the references, each one
    pairwise block times the tile's one-hot rows.  An empty cluster
    (two medoids that coincide or tie for every point) keeps its
    medoid."""
    n = data.shape[0]
    _, _, assign = medoid_cache(data, med, metric=metric, backend=be_name)
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    full_fp32(data)
    cost = torch.zeros((n, k), dtype=torch.float32, device=data.device)
    for lo in range(0, n, VORONOI_TILE):
        dblk = be.pairwise(data, data[lo:lo + VORONOI_TILE], metric=metric)
        cost += dblk @ onehot[lo:lo + VORONOI_TILE]
    member = onehot > 0
    cost = torch.where(member, cost, float("inf"))
    nonempty = torch.any(member, dim=0)
    return torch.where(nonempty, torch.argmin(cost, dim=0), med)


def voronoi_iteration(data, k: int, metric="l2", max_iters: int = 50,
                      seed: int = 0, *, backend: str = "auto",
                      device: DeviceLike = None) -> FitReport:
    """Voronoi iteration from a uniform draw of medoids, until the
    medoids repeat or ``max_iters``; n·n + n·k evaluations per
    iteration."""
    data, metric, be_name, dev = _setup(data, metric, backend, device)
    be = get_stats_backend(be_name)
    n, k = data.shape[0], int(k)
    rng = np.random.default_rng(seed)
    med = torch.as_tensor(rng.choice(n, size=k, replace=False).astype(
        np.int64), device=dev)
    res = FitReport(medoids=np.zeros(k, np.int64), loss=np.inf)
    _sync(dev)
    t0 = time.perf_counter()
    evals = 0
    converged = False
    for _ in range(max_iters):
        new = _voronoi_update(be, data, med, k, metric, be_name)
        evals += n * n + n * k
        (same,) = host_read([torch.all(new == med)], res, "alternate")
        if same:
            converged = True
            break
        med = new
    loss = total_loss(data, med, metric=metric, backend=be_name)
    medoids, loss_h = host_read([med, loss], res, "alternate")
    _sync(dev)
    res.wall_by_phase["alternate"] = time.perf_counter() - t0
    res.medoids = np.asarray(medoids, np.int64)
    res.loss = loss_h
    res.distance_evals = evals
    res.converged = converged
    res.evals_by_phase = {"alternate": evals}
    return res


# ---------------------------------------------------------------------------
# CLARANS — randomized swap-graph search
# ---------------------------------------------------------------------------

def clarans(data, k: int, metric="l2", num_local: int = 2,
            max_neighbors: Optional[int] = None, seed: int = 0, *,
            backend: str = "auto", device: DeviceLike = None) -> FitReport:
    """``num_local`` local searches from uniform draws; each takes a
    random neighbour (medoid slot and non-medoid drawn uniformly, the
    non-medoid through the sorted medoids as an order statistic) and
    moves to it if its loss is lower, until ``max_neighbors`` neighbours
    in a row fail.  n·k evaluations per loss."""
    data, metric, be_name, dev = _setup(data, metric, backend, device)
    n, k = data.shape[0], int(k)
    if max_neighbors is None:
        max_neighbors = max(250, int(0.0125 * k * (n - k)))
    rng = np.random.default_rng(seed)
    res = FitReport(medoids=np.zeros(k, np.int64), loss=np.inf)
    _sync(dev)
    t0 = time.perf_counter()

    def loss_of(med: np.ndarray) -> float:
        (v,) = host_read([total_loss(data, torch.as_tensor(med, device=dev),
                                     metric=metric, backend=be_name)],
                         res, "search")
        return v

    best_loss, best_medoids = np.inf, None
    evals = 0
    for _ in range(num_local):
        cur = rng.choice(n, size=k, replace=False).astype(np.int64)
        cur_loss = loss_of(cur)
        evals += n * k
        cur_sorted = np.sort(cur)
        j = 0
        while j < max_neighbors:
            m_idx = int(rng.integers(k))
            x = int(rng.integers(n - k))
            for mval in cur_sorted:
                if x >= mval:
                    x += 1
            cand = cur.copy()
            cand[m_idx] = x
            cand_loss = loss_of(cand)
            evals += n * k
            if cand_loss < cur_loss:
                cur, cur_loss, j = cand, cand_loss, 0
                cur_sorted = np.sort(cur)
            else:
                j += 1
        if cur_loss < best_loss:
            best_loss, best_medoids = cur_loss, cur
    _sync(dev)
    res.wall_by_phase["search"] = time.perf_counter() - t0
    res.medoids = best_medoids
    res.loss = best_loss
    res.distance_evals = evals
    res.evals_by_phase = {"search": evals}
    return res


# ---------------------------------------------------------------------------
# CLARA — PAM on subsamples
# ---------------------------------------------------------------------------

def clara(data, k: int, metric="l2", n_samples: int = 5,
          sample_size: Optional[int] = None, seed: int = 0, *,
          backend: str = "auto", device: DeviceLike = None) -> FitReport:
    """PAM (FastPAM1 accounting) on ``n_samples`` uniform subsamples of
    ``sample_size`` points (default ``min(n, 40 + 2k)``), each scored on
    all n points (n·k evaluations); the best is kept."""
    data, metric, be_name, dev = _setup(data, metric, backend, device)
    n, k = data.shape[0], int(k)
    if sample_size is None:
        sample_size = min(n, 40 + 2 * k)
    rng = np.random.default_rng(seed)
    res = FitReport(medoids=np.zeros(k, np.int64), loss=np.inf)
    _sync(dev)
    t0 = time.perf_counter()
    best_loss, best_medoids = np.inf, None
    evals = 0
    for _ in range(n_samples):
        sub_idx = rng.choice(n, size=sample_size, replace=False)
        sub = data.index_select(0, torch.as_tensor(sub_idx, device=dev))
        sub_res = pam(sub, k, metric=metric, backend=be_name, device=dev)
        evals += sub_res.distance_evals
        medoids = sub_idx[sub_res.medoids]
        (loss,) = host_read([total_loss(
            data, torch.as_tensor(medoids, device=dev), metric=metric,
            backend=be_name)], res, "subsample")
        evals += n * k
        if loss < best_loss:
            best_loss, best_medoids = loss, medoids
    _sync(dev)
    res.wall_by_phase["subsample"] = time.perf_counter() - t0
    res.medoids = np.asarray(best_medoids, np.int64)
    res.loss = best_loss
    res.distance_evals = evals
    res.evals_by_phase = {"subsample": evals}
    return res
