"""Batched multi-fit: ``BanditPAM.fit_batch`` in PyTorch (counterpart of
``repro.core.banditpam.BanditPAM.fit_batch`` and its ``_build_batch`` /
``_swap_batch`` / ``_batch_rng_chains`` / ``_batch_perms``).

Many independent clusterings in one call (one per cell type, per patient,
per exercise).  The JAX package runs each phase of the whole batch as one
dispatch (``lax.map`` over lanes); on the card a fit is paced by the host
enqueuing its bandit rounds, so a loop of B fits would pay that host cost
B times.  The port's counterpart is lockstep lanes:

* the datasets are padded to ``[L, n_pad, d]`` (``engine.LaneData``; pad
  rows are never an arm and never a reference), and every lane has its
  own seed's draws (``rng.from_seed``), its own δ (1/(1000·n_i) in
  BUILD, 1/(1000·k·n_i) in SWAP) and its own ``log(1/δ)`` term;
* BUILD runs its k searches in lockstep across lanes and SWAP its
  iteration t for every lane that has not converged: each is one
  ``adaptive.lane_search``, whose every round launches ``build_g`` or
  ``swap_g`` once for the whole batch, the lanes that have stopped (or
  converged, or are past their own budget) masked on the device;
* the medoid cache and the candidate loss are one lane ``top2`` launch;
  each lane's loss is the sum over its own intact ``[n_i]`` slice, as a
  single fit's (a sum over the padded row would change the bits the
  accept rule reads);
* the host reads the lanes' flags once every ``ROUNDS_PER_READ`` rounds,
  every lane's picks and ledger once at BUILD's end, and once per SWAP
  iteration every lane's pick, loss, accept bit and ledger terms; so a
  batch of identical lanes reads exactly what one fit reads, and launches
  ``build_g`` / ``swap_g`` as often as one fit does.

Each lane's arithmetic is the single fit's on its own slice (the lane
kernels give each lane the single launch's bits; the plain backend loops
over the lanes), so every fit equals ``BanditPAM(seed=seeds[i]).fit``
bit for bit: medoids, loss, swap history, build rounds and ledger.

``reuse="pic"`` (``banditpam_pp``) runs lockstep lanes too, each lane
with its own PIC ring (``pic_cache.LaneRing``: ``[L, n_pad, (W+1)·B]``,
every lane at the batch's width ``pic_cache.resolve_batch_cache_rounds``,
the JAX package's rule), its own fixed permutation and its own host
``hw`` / ``fresh_pos``:

* every search's ``[R, L]`` table of served, new and recycled rounds is
  built once, at its start (``pic_cache.lane_plan``); each round makes
  one lane ``pairwise`` launch that writes the fresh blocks (a new
  round's into its slot, a recycled round's into the lane's scratch, a
  served lane at run flag 0), then the served statistics of every
  lane's block: BUILD by the plain math, SWAP by one lane
  ``swap_g_from_cache`` launch;
* a lane's rounds served from its window are charged to its cached
  ledger (``lane_search``'s ``free``); a BUILD search reads the lanes'
  round counts at its end only while some lane's window can still grow
  (the single fit's rule), and a SWAP iteration reads them with its one
  read;
* a SWAP search seeds each carrying lane (no round of its ring recycled)
  with the last search's moments, repaired for every such lane at once
  by two lane ``swap_g_from_cache`` launches over the whole rings
  (``banditpam._carry_delta_lanes``); a lane whose ring has recycled
  starts cold, as the single fit does.

So a batch of identical PIC lanes reads and launches what one fit does.
After each BUILD pick every lane's ``d_near`` row is one lane ``pairwise``
launch (the pick's row against the lane's own rows, the single fit's
orientation), in both modes.
"""

from __future__ import annotations

import time
import types
from typing import List

import numpy as np
import torch

from . import rng as _rng
from . import threefry, tuning
from .adaptive import lane_search, log_term_f32, tile_perm
from .banditpam import _carry_delta_lanes
from .device import resolve_device
from .distances import check_data
from .engine import (LaneBlocks, LaneData, bind_stats_backend, host_read,
                     host_stage, phase_sync, resolve_stats_backend)
from .pic_cache import (lane_advance, lane_plan, make_lane_ring,
                        resolve_batch_cache_rounds, to_device)
from .report import BatchFitReport, FitReport

__all__ = ["fit_batch", "lane_arrays", "lane_losses", "validate_batch"]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(
        a, np.float32), dtype=torch.float32)


def lane_arrays(datasets) -> List[torch.Tensor]:
    """A ``[B, n, d]`` array or tensor, or a list of ``[n_i, d]`` ones, as
    a list of float32 tensors (on the CPU unless given on a device)."""
    if isinstance(datasets, (list, tuple)):
        return [_f32(a) for a in datasets]
    a = _f32(datasets)
    if a.ndim != 3:
        raise ValueError(f"expected [B, n, d] batch or a list of "
                         f"[n_i, d] arrays, got shape {tuple(a.shape)}")
    return list(a.unbind(0))


def validate_batch(bp, datasets, seeds):
    """The JAX package's checks, with its messages' meaning.  Returns the
    datasets (:func:`lane_arrays`) and the seeds as ints."""
    if bp.sampling != "permutation":
        raise ValueError('fit_batch requires sampling="permutation" '
                         "(per-fit reference layouts are precomputed)")
    if bp.cache_cols > 0:
        raise ValueError("fit_batch does not support cache_cols warm "
                         "blocks (ragged per-fit warm widths); use "
                         "reuse='pic'")
    arrs = lane_arrays(datasets)
    if not arrs:
        raise ValueError("empty batch")
    if any(x.ndim != 2 for x in arrs):
        raise ValueError("every dataset must be [n_i, d]")
    if len({x.shape[1] for x in arrs}) != 1:
        raise ValueError("all datasets must share the feature dim")
    if min(x.shape[0] for x in arrs) <= bp.k:
        raise ValueError("need n > k in every dataset")
    seeds = ([bp.seed] * len(arrs) if seeds is None
             else [int(s) for s in seeds])
    if len(seeds) != len(arrs):
        raise ValueError(f"{len(seeds)} seeds for {len(arrs)} datasets")
    return arrs, seeds


def lane_losses(d1: torch.Tensor, ns: List[int], live=None) -> torch.Tensor:
    """Each lane's loss, ``[L]`` float32: the sum of its nearest-medoid
    distances over its own intact ``[n_i]`` slice (``engine.total_loss``'s
    sum).  A lane that is not ``live`` (a host list) gets 0."""
    zero = torch.zeros((), dtype=torch.float32, device=d1.device)
    return torch.stack([torch.sum(d1[i, :n]) if live is None or live[i]
                        else zero for i, n in enumerate(ns)])


def _lane_perms(layouts, phase: str, s: int, lanes: LaneData, B: int,
                live=None):
    """Search ``s`` of ``phase`` for every lane: each lane's permutation
    tiled cyclically (``adaptive.tile_perm``) and padded to ``[L,
    R_max·B]`` with index 0 at weight 0; a lane that is not ``live``
    draws nothing and keeps the padding.  The lanes of one n draw
    together (``threefry.permutations``, the JAX package's
    ``_batch_perms``)."""
    dev = lanes.data.device
    L = len(lanes.ns)
    width = -(-max(lanes.ns) // B) * B
    idx = torch.zeros((L, width), dtype=torch.int64, device=dev)
    w = torch.zeros((L, width), dtype=torch.float32, device=dev)
    for n, group in lanes.groups():
        if live is not None:
            group = [i for i in group if live[i]]
        if not group:
            continue
        perms = threefry.permutations(
            [layouts[i].perm_key(phase, s) for i in group], n, dev)
        pi, pw = tile_perm(perms, n, B)
        total = pi.shape[1]
        rows = to_device(group, torch.int64, dev)
        idx[:, :total].index_copy_(0, rows, pi)
        w[:, :total].index_copy_(0, rows, pw.expand(len(group), total))
    return idx, w


def _log_terms(deltas, dev) -> torch.Tensor:
    """Each lane's ``log(1/δ)`` exactly as a single fit folds it
    (``adaptive.log_term_f32``), ``[L]`` float32 on ``dev``."""
    return to_device(torch.stack([log_term_f32(d, "cpu") for d in deltas]),
                     torch.float32, dev)


class _PicLanes:
    """The PIC batch's lane state: the rings, each lane's fixed
    permutation tiled for the searches (``pidx`` / ``pw`` ``[L, R·B]``)
    and for the carried repair at the ring's width (``pidx_c`` / ``pw_c``
    ``[L, W·B]``), each lane's round budget and its rounds' sizes."""

    def __init__(self, bp, lanes: LaneData, layouts):
        ns, B, dev = lanes.ns, bp.batch_size, lanes.data.device
        L = len(ns)
        W = resolve_batch_cache_rounds(ns, B, bp.cache_width)
        self.ring = make_lane_ring(L, lanes.n_pad, B, W, dev)
        self.B = B
        self.budget = [-(-n // B) for n in ns]
        self.sizes = [tuple(min(B, n - r * B) for r in range(R))
                      for n, R in zip(ns, self.budget)]
        width = max(self.budget) * B
        self.pidx = torch.zeros((L, width), dtype=torch.int64, device=dev)
        self.pw = torch.zeros((L, width), dtype=torch.float32, device=dev)
        self.pidx_c = torch.zeros((L, W * B), dtype=torch.int64, device=dev)
        self.pw_c = torch.zeros((L, W * B), dtype=torch.float32, device=dev)
        pos = torch.arange(W * B, device=dev)
        for n, group in lanes.groups():
            perms = threefry.permutations([layouts[i].ckey for i in group],
                                          n, dev)
            rows = to_device(group, torch.int64, dev)
            pi, pw = tile_perm(perms, n, B)
            self.pidx[:, :pi.shape[1]].index_copy_(0, rows, pi)
            self.pw[:, :pi.shape[1]].index_copy_(
                0, rows, pw.expand(len(group), -1))
            # The cyclic tiling's prefix at the ring's width.
            reps = perms.repeat(1, -(-(W * B) // n))[:, :W * B]
            self.pidx_c.index_copy_(0, rows, reps)
            self.pw_c.index_copy_(0, rows, (pos < n).to(torch.float32).expand(
                len(group), -1))

    def plan(self):
        return lane_plan(self.ring, self.budget, max(self.budget))

    def blocks(self, be, lanes: LaneData, plan, rnd: int, ref_idx, run,
               metric: str) -> LaneBlocks:
        """Round ``rnd``'s block of every lane: one lane ``pairwise``
        launch computes the fresh ones (where some lane has one) under
        each lane's flag times its fresh bit."""
        col = plan.col_dev[rnd]
        if plan.any_fresh[rnd]:
            be.pairwise_lanes(lanes.data, lanes.gather(ref_idx),
                              metric=metric, out=self.ring.store, col=col,
                              xrows=lanes.rows,
                              run=run * plan.fresh_dev[rnd])
        return LaneBlocks(self.ring.store, plan.col[rnd], col, self.B)


def _build_batch(bp, lanes: LaneData, be, layouts, stats: dict, pic=None):
    """BUILD for every lane: k lockstep lane searches, each pick updating
    its lane's medoid mask and ``d_near`` on the device (one lane
    ``pairwise`` launch), then ONE read of every lane's picks, rounds and
    ledger.  Returns the ``[L, k]`` device medoids and the per-lane host
    picks, rounds and BUILD ledgers (and, under PIC, cached ledgers)."""
    ns, L, k, B = lanes.ns, len(lanes.ns), bp.k, bp.batch_size
    dev = lanes.data.device
    log_b = _log_terms([bp.delta if bp.delta is not None
                        else 1.0 / (1000.0 * n) for n in ns], dev)
    valid = (torch.arange(lanes.n_pad, device=dev)[None, :]
             < lanes.rows[:, None])
    dnear = torch.full((L, lanes.n_pad), float("inf"), dtype=torch.float32,
                       device=dev)
    med_mask = torch.zeros((L, lanes.n_pad), dtype=torch.bool, device=dev)
    found, later = [], []   # later: PIC searches charged at BUILD's end
    fresh0 = list(pic.ring.fresh_pos) if pic else None
    for i in range(k):
        kw = {}
        if pic is None:
            def stats_fn(rnd, ref_idx, w, lead, run):
                return be.build_stats_lanes(lanes, ref_idx,
                                            dnear.gather(1, ref_idx), w,
                                            lead, metric=bp.metric, run=run)

            pidx, pw = _lane_perms(layouts, "build", i, lanes, B)
        else:
            plan = pic.plan()

            def stats_fn(rnd, ref_idx, w, lead, run, plan=plan):
                blocks = pic.blocks(be, lanes, plan, rnd, ref_idx, run,
                                    bp.metric)
                return be.build_stats_from_d_lanes(
                    lanes, blocks, dnear.gather(1, ref_idx), w, lead)

            pidx, pw = pic.pidx, pic.pw
            # A lane's window moves only while its hw is short of its
            # budget; then the next search needs the round counts now.
            kw = dict(free=plan.free, rounds_to_host=any(
                h < b for h, b in zip(pic.ring.hw, pic.budget)))
        sr = lane_search(stats_fn=stats_fn, n_ref=ns, n_dev=lanes.rows,
                         batch_size=B, log_term=log_b,
                         active_init=valid & ~med_mask, perm_idx=pidx,
                         perm_w=pw, baseline=bp.baseline,
                         report=stats["reads"], phase="build",
                         rounds_log=stats["rounds"], **kw)
        if pic is not None and sr.rounds_h is not None:
            lane_advance(pic.ring, plan, range(L), [0] * L, sr.rounds_h,
                         pic.sizes)
        elif pic is not None:
            later.append((i, plan))
        med_mask.scatter_(1, sr.best[:, None], True)
        rows = be.pairwise_lanes(lanes.gather(sr.best[:, None]), lanes.data,
                                 metric=bp.metric, yrows=lanes.rows)
        dnear = torch.where(valid, torch.minimum(dnear, rows[:, 0]), dnear)
        found.append(sr)
    vals = host_read([s.best for s in found] + [s.rounds for s in found]
                     + [s.n_evals_cached if pic else s.n_evals
                        for s in found], stats["reads"], "build")
    picks = [[vals[i][j] for i in range(k)] for j in range(L)]
    rounds = [[vals[k + i][j] for i in range(k)] for j in range(L)]
    counted = [sum(vals[2 * k + i][j] for i in range(k)) for j in range(L)]
    if pic is None:
        evals = [{"build": c + n * k} for c, n in zip(counted, ns)]
    else:
        for i, plan in later:
            lane_advance(pic.ring, plan, range(L), [0] * L,
                         [r[i] for r in rounds], pic.sizes)
        # n per fresh column position; cached: the rounds served.
        evals = [{"build": n * (pic.ring.fresh_pos[j] - fresh0[j]) + n * k,
                  "build_cached": counted[j]} for j, n in enumerate(ns)]
    med_t = torch.stack([s.best for s in found], dim=1)
    return med_t, picks, rounds, evals


def _swap_batch(bp, lanes: LaneData, be, layouts, med_t, picks,
                stats: dict, pic=None):
    """SWAP for every lane: iteration t is one lane search over the lanes
    that have not converged (the others masked from its first round),
    their candidate losses from one lane ``top2`` launch, the float32
    accept rule per lane on the device, and ONE read of every lane's
    pick, loss, accept bit and ledger terms.  Under PIC each carrying
    lane's search is seeded with its last search's repaired moments."""
    ns, L, k, B = lanes.ns, len(lanes.ns), bp.k, bp.batch_size
    n_pad = lanes.n_pad
    dev = lanes.data.device
    reads = stats["reads"]
    log_s = _log_terms([bp.delta if bp.delta is not None
                        else 1.0 / (1000.0 * k * n) for n in ns], dev)
    valid = (torch.arange(n_pad, device=dev)[None, :]
             < lanes.rows[:, None])
    d1, _, _ = be.top2_lanes(lanes, med_t, metric=bp.metric)
    prev_loss = lane_losses(d1, ns)
    (loss,) = host_read([prev_loss], reads, "swap")
    medoids = [list(p) for p in picks]
    history = [[] for _ in range(L)]
    evals = [{"swap": 0, "swap_cached": 0} if pic else {"swap": 0}
             for _ in range(L)]
    converged = [False] * L
    live = [True] * L
    live_dev = torch.ones((L,), dtype=torch.bool, device=dev)
    carry = None  # (sums, sqsums, rounds, rounds_h, d1, d2, assign)

    def count_fn(active):
        # FastPAM1: one distance per (x, y) pair serves all k arms (·, x).
        return torch.sum(torch.any(active.view(L, k, n_pad), dim=1), dim=1,
                         dtype=torch.int64)

    for t in range(bp.max_swaps):
        if not any(live):
            break
        med_mask = torch.zeros((L, n_pad), dtype=torch.bool, device=dev)
        med_mask.scatter_(1, med_t, True)
        d1, d2, assign = be.top2_lanes(lanes, med_t, metric=bp.metric,
                                       live=live_dev)
        kw = {}
        n_changed = torch.zeros((L,), dtype=torch.int64, device=dev)
        if pic is None:
            def stats_fn(rnd, ref_idx, w, lead, run):
                d1_b, d2_b, a_b = (v.gather(1, ref_idx)
                                   for v in (d1, d2, assign))
                return be.swap_stats_lanes(lanes, ref_idx, d1_b, d2_b, a_b,
                                           w, k, lead, metric=bp.metric,
                                           run=run)

            pidx, pw = _lane_perms(layouts, "swap", t, lanes, B, live)
        else:
            carrying = [carry is not None and live[j]
                        and pic.ring.carry_valid(j) for j in range(L)]
            if any(carrying):
                # Virtual arms: each carrying lane's last moments, repaired
                # where the accepted swap moved (d1, d2, assign).
                c_sums, c_sq, c_rounds, c_rounds_h, d1o, d2o, ao = carry
                run_c = to_device(carrying, torch.int32, dev)
                s0, q0, changed = _carry_delta_lanes(
                    be, lanes, pic.ring, pic.pidx_c, pic.pw_c, c_rounds * B,
                    (d1o, d2o, ao), (d1, d2, assign), c_sums, c_sq, k, run_c)
                n_changed = changed * run_c
                kw = dict(init_sums=s0, init_sqsums=q0, init_rounds=[
                    r if c else None for r, c in zip(c_rounds_h, carrying)])
            plan = pic.plan()

            def stats_fn(rnd, ref_idx, w, lead, run, plan=plan):
                blocks = pic.blocks(be, lanes, plan, rnd, ref_idx, run,
                                    bp.metric)
                d1_b, d2_b, a_b = (v.gather(1, ref_idx)
                                   for v in (d1, d2, assign))
                return be.swap_stats_from_d_lanes(lanes, blocks, d1_b, d2_b,
                                                  a_b, w, k, lead, run=run)

            pidx, pw = pic.pidx, pic.pw
            kw["free"] = plan.free
        active = valid & ~med_mask & live_dev[:, None]
        sr = lane_search(stats_fn=stats_fn, n_ref=ns, n_dev=lanes.rows,
                         batch_size=B, log_term=log_s,
                         active_init=active.repeat(1, k), perm_idx=pidx,
                         perm_w=pw, count_fn=count_fn, baseline=bp.baseline,
                         stop_when_positive=bp.swap_early_stop, live=live,
                         report=reads, phase="swap",
                         rounds_log=stats["rounds"], **kw)
        cand = med_t.scatter(1, (sr.best // n_pad)[:, None],
                             (sr.best % n_pad)[:, None])
        d1c, _, _ = be.top2_lanes(lanes, cand, metric=bp.metric,
                                  live=live_dev)
        new_loss = lane_losses(d1c, ns, live)
        # The JAX package's accept rule, float32 on the device, per lane.
        accept = (new_loss < prev_loss - 1e-7 * torch.clamp_min(
            torch.abs(prev_loss), 1.0)) & live_dev
        terms = [sr.n_evals]
        if pic is not None:
            terms += [sr.n_evals_cached, n_changed, sr.rounds]
        best_h, new_loss_h, accept_h, *terms_h = host_read(
            [sr.best, new_loss, accept] + terms, reads, "swap")
        if pic is not None:
            fresh0 = list(pic.ring.fresh_pos)
            lane_advance(pic.ring, plan, [j for j in range(L) if live[j]],
                         [r or 0 for r in kw.get("init_rounds", [0] * L)],
                         terms_h[3], pic.sizes)
        for j, n in enumerate(ns):
            if not live[j]:
                continue
            if pic is None:
                evals[j]["swap"] += 2 * n * k + terms_h[0][j]
            else:
                # Fresh: n per fresh column position; cached: the rounds
                # served from the ring plus n per repaired point.
                evals[j]["swap"] += (2 * n * k + n * (pic.ring.fresh_pos[j]
                                                      - fresh0[j]))
                evals[j]["swap_cached"] += (terms_h[1][j]
                                            + n * terms_h[2][j])
            if not accept_h[j]:
                converged[j], live[j] = True, False
                continue
            m_idx, x_idx = divmod(best_h[j], n_pad)
            old = medoids[j][m_idx]
            medoids[j][m_idx] = x_idx
            history[j].append((old, x_idx, new_loss_h[j]))
            loss[j] = new_loss_h[j]
        if pic is not None:
            carry = (sr.sums, sr.sqsums, sr.rounds, terms_h[3], d1, d2,
                     assign)
        med_t = torch.where(accept[:, None], cand, med_t)
        prev_loss = torch.where(accept, new_loss, prev_loss)
        live_dev = accept
    return medoids, loss, history, evals, converged


def _lockstep(bp, arrs, seeds, dev, be_name):
    """The whole batch in lockstep lanes, either ``reuse`` mode, every
    launch in the tiles resolved once for the batch (``tuning``, keyed on
    the rows one launch covers, every lane's; no ``observe``, as in the
    JAX package)."""
    with host_stage("the batch's data"):
        lanes = LaneData.pad([a.to(dev) for a in arrs], dev)
    be = bind_stats_backend(be_name, tuning.resolve_tile_config(
        len(arrs) * lanes.n_pad, lanes.data.shape[2], bp.k,
        tuning.current_device_kind(dev), be_name))
    layouts = [_rng.from_seed(s, dev, bp.k) for s in seeds]
    pic = _PicLanes(bp, lanes, layouts) if bp.reuse == "pic" else None
    # host_read counts into a report's host_reads_by_phase.
    stats = {"reads": types.SimpleNamespace(host_reads_by_phase={}),
             "rounds": {}}
    phase_sync(dev)
    t0 = time.perf_counter()
    med_t, picks, rounds, build_evals = _build_batch(bp, lanes, be, layouts,
                                                     stats, pic)
    phase_sync(dev)
    wall = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    medoids, loss, history, swap_evals, converged = _swap_batch(
        bp, lanes, be, layouts, med_t, picks, stats, pic)
    phase_sync(dev)
    wall["swap"] = time.perf_counter() - t0
    reports = []
    for j in range(len(arrs)):
        res = FitReport(medoids=np.asarray(medoids[j], np.int64),
                        loss=loss[j], converged=converged[j],
                        build_rounds=rounds[j], swap_history=history[j])
        res.evals_by_phase = {**build_evals[j], **swap_evals[j]}
        res.n_swaps = len(history[j])
        res.distance_evals = sum(v for ph, v in res.evals_by_phase.items()
                                 if not ph.endswith("_cached"))
        res.cached_evals = sum(v for ph, v in res.evals_by_phase.items()
                               if ph.endswith("_cached"))
        reports.append(res)
    return reports, wall, stats["rounds"], stats["reads"].host_reads_by_phase


def fit_batch(bp, datasets, seeds=None) -> BatchFitReport:
    """``BanditPAM.fit_batch``: see the module docstring."""
    arrs, seeds = validate_batch(bp, datasets, seeds)
    dev = resolve_device(bp.device)
    for a in arrs:
        check_data(a, bp.metric)
    be_name = resolve_stats_backend(bp.backend, bp.metric, dev)
    reports, wall, rounds, reads = _lockstep(bp, arrs, seeds, dev, be_name)
    return BatchFitReport(
        reports=reports, medoids=np.stack([r.medoids for r in reports]),
        loss=np.asarray([r.loss for r in reports], np.float64),
        n_valid=np.asarray([a.shape[0] for a in arrs], np.int64),
        wall_by_phase=wall, dispatches_by_phase=rounds,
        host_reads_by_phase=reads)
