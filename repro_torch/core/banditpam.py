"""BanditPAM: BUILD + SWAP driven by Algorithm 1, in PyTorch.

Counterpart of ``repro.core.banditpam.BanditPAM.fit`` for every sampling
mode, baseline and cache regime:

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

The distance caches (``engine.FitContext``), both over ONE fixed
reference permutation walked by every search (``layouts.fixed_perm``):

* ``cache_cols=C > 0`` with ``reuse="none"`` and permutation sampling:
  the paper's App 2.2 warm block, the columns of the first ``C // B``
  rounds computed once up front (``cache_warm`` = n·C in the ledger);
  those rounds are served from it in every search.
* ``reuse="pic"`` (BanditPAM++): the bounded column ring of
  ``core.pic_cache`` (``cache_width`` columns, default 32 rounds), written
  through by every round that computes its block fresh, so later
  searches replay it; with ``cache_cols`` the ring's first rounds are
  warmed up front (clamped to the ring).  Virtual arms: each SWAP search
  hands its per-arm Σg / Σg² to the next, which :func:`_carry_delta`
  repairs only at the reference points whose (d1, d2, assign) the
  accepted swap moved, from the ring; it runs while no round has been
  recycled (``pic_cache.carry_valid``), and otherwise the search starts
  cold.  The ledger splits: fresh pays n per position whose column was
  computed (``build``, ``swap``, ``cache_warm``), cached tallies the
  rounds served from the ring and the repairs, n per changed point
  (``build_cached``, ``swap_cached``).  The SWAP rounds from the ring and
  the repairs run through the ``swap_g_from_cache`` kernel on the card.
  ``sampling="replacement"`` refuses ``reuse="pic"`` and ignores
  ``cache_cols``, as in the JAX package.

The drivers (``fused``), the counterparts of the JAX package's: every
device-to-host read goes through ``engine.host_read`` and is counted in
``FitReport.host_reads_by_phase``.  ``fused=True`` (the default) runs the
device-resident searches (``adaptive.py``) in every sampling and cache
mode: a BUILD pick stays a device index that updates the medoid mask and
``d_near`` on the device, so BUILD reads its searches' flags once every
``adaptive.ROUNDS_PER_READ`` rounds and its picks and ledger once at its
end; a SWAP iteration reads its search's flags the same way, then the
pick, the candidate loss, the accept bit and the ledger terms in one
read.  Replacement sampling decides its exact fallback on the device.
Under ``reuse="pic"`` the ring's window moves a search at a time
(``pic_cache.search_read_or_write`` / ``search_advance``): a round past
its search's stop passes its run flag to the pairwise launch that would
write its slot, and the host learns each search's round count with the
flag's reads (a BUILD search that ran to its budget while the window
could still grow is read once more), with BUILD's end read, or with the
SWAP iteration's read.  ``fused=False`` runs the stepped
searches (one read per round), and so, by one rule, does a replacement
fit whose draws come from ``rng.from_generator``: it draws in
consumption order, so a round enqueued past a search's stop would shift
every later search's draws.  The two give identical reports.

``fit_batch`` fits many independent datasets in one call
(``core/batch.py``): every lane advances one bandit round at a time,
each round one ``build_g`` or ``swap_g`` launch for the whole batch, or
under ``reuse="pic"`` one lane ``pairwise`` launch for the fresh blocks
of every lane's ring and the served statistics (SWAP: one lane
``swap_g_from_cache`` launch), with :func:`_carry_delta_lanes` repairing
every carrying lane's moments at once.  Each fit equals the single fit
with its seed, bit for bit.

Random draws: every search takes its reference permutation, or in
replacement mode its per-round batches, from a layout source
(``repro_torch.core.rng``).  The default replays the JAX package's
threefry chain for ``seed`` (``rng.from_seed``), so the same seed gives
the JAX fit's draws and hence its medoids; ``layouts=`` replaces the
source (``rng.from_generator``, or given draws through
``repro_torch.convert``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .adaptive import cyclic_layout, device_search, log_term_f32
from .device import DeviceLike, resolve_device
from .distances import check_data, resolve_metric
from .engine import (FitContext, bind_stats_backend, exact_build_means,
                     exact_swap_means, host_read, host_stage, medoid_cache,
                     phase_sync, resolve_stats_backend, stream_columns,
                     total_loss)
from .pic_cache import (carry_valid, make_cache, resolve_cache_rounds,
                        search_advance, search_read_or_write)
from .report import FitReport
from . import rng as _rng
from . import tuning

__all__ = ["BanditPAM", "FitReport", "FitResult", "medoid_cache",
           "total_loss"]

# The JAX package's older name for the report, kept importable.
FitResult = FitReport


def _repair_weights(pidx, pw, n_prefix: int, old, new):
    """The carried repair's weights over the ring's positions: ``pw`` on
    the permutation prefix ``[0, n_prefix)`` where the point ``pidx``'s
    (d1, d2, assign) moved from ``old`` to ``new`` (each a triple of
    per-point vectors), 0 elsewhere; with the old and new triples at the
    positions.  Exact comparison finds the changed points: an unchanged
    entry of the medoid cache is a bit-identical recomputation."""
    in_prefix = (torch.arange(pidx.shape[0], device=pidx.device)
                 < n_prefix).to(torch.float32)
    b = tuple(v[pidx] for v in old)
    c = tuple(v[pidx] for v in new)
    changed = ((b[0] != c[0]) | (b[1] != c[1]) | (b[2] != c[2])).to(
        torch.float32)
    return pw * in_prefix * changed, b, c


def _carry_delta(be, cols, pidx, pw, n_prefix: int, d1o, d2o, ao, d1n, d2n,
                 an, sums, sqsums, k: int):
    """Re-validate carried SWAP arm statistics after an accepted swap.

    The carried Σg / Σg² over the permutation prefix ``[0, n_prefix)``
    were summed under the previous (d1, d2, assign).  With
    ``g = base_x + 1[y ∈ C_m]·corr_x``, the swap changes g only at the
    reference points y whose (d1, d2, assign) moved; their old
    contributions are taken out and the new ones put in by two passes of
    the backend's cache-served SWAP statistics over the WHOLE ring
    ``cols`` [n, W·B] with weight ``pw·in_prefix·changed`` (the
    ``swap_g_from_cache`` kernel on the card), so the repair costs no
    fresh evaluation (:func:`_repair_weights`).  The caller guarantees
    ``n_prefix ≤ W·B`` and that no round was recycled, so ring slots are
    the identity map of positions.

    Returns ``(sums', sqsums', n_changed)``, ``n_changed`` a 0-d int64
    tensor (positions repaired).
    """
    w, b, c = _repair_weights(pidx, pw, n_prefix, (d1o, d2o, ao),
                              (d1n, d2n, an))
    s_old, q_old, _ = be.swap_stats_from_d(cols, *b, w, k, None)
    s_new, q_new, _ = be.swap_stats_from_d(cols, *c, w, k, None)
    return (sums - s_old + s_new, sqsums - q_old + q_new,
            torch.count_nonzero(w))


def _carry_delta_lanes(be, lanes, ring, pidx, pw, n_prefix, old, new,
                       sums, sqsums, k: int, run):
    """:func:`_carry_delta` for every carrying lane of a PIC batch at once
    (``fit_batch``): ``pidx`` / ``pw`` ``[L, W·B]`` each lane's tiling at
    its ring's width, ``n_prefix`` ``[L]`` int64 the carried prefixes,
    ``old`` / ``new`` the lanes' ``[L, n_pad]`` triples, ``sums`` /
    ``sqsums`` ``[L, k·n_pad]``, and ``run`` ``[L]`` int32 the carrying
    lanes.  The two passes are one lane ``swap_g_from_cache`` launch each
    over every lane's whole ring (``ring`` a ``pic_cache.LaneRing``), with
    each lane's :func:`_repair_weights`; lane l gets the single repair's
    bits.  Returns ``(sums', sqsums', n_changed [L])``; a lane whose flag
    reads 0 gets values for the caller to discard."""
    from .engine import LaneBlocks
    in_prefix = (torch.arange(pidx.shape[1], device=pidx.device)[None, :]
                 < n_prefix[:, None]).to(torch.float32)
    b = tuple(v.gather(1, pidx) for v in old)
    c = tuple(v.gather(1, pidx) for v in new)
    changed = ((b[0] != c[0]) | (b[1] != c[1]) | (b[2] != c[2])).to(
        torch.float32)
    w = pw * in_prefix * changed
    blocks = LaneBlocks(ring.store, [0] * pidx.shape[0], None, ring.scratch)
    s_old, q_old, _ = be.swap_stats_from_d_lanes(lanes, blocks, *b, w, k,
                                                 None, run=run)
    s_new, q_new, _ = be.swap_stats_from_d_lanes(lanes, blocks, *c, w, k,
                                                 None, run=run)
    return (sums - s_old + s_new, sqsums - q_old + q_new,
            torch.count_nonzero(w, dim=1))


class BanditPAM:
    """k-medoids via adaptive sampling; same medoids as PAM w.h.p.

    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` for the plain path.  ``backend`` is ``"auto"``,
    ``"cuda"``, ``"torch"`` or any registered stats backend.
    ``cache_width`` caps the ``reuse="pic"`` ring in reference columns
    (rounded down to whole rounds; ``None``: 32 rounds); ``cache_width=n``
    holds an n × n float32 ring.  ``cache_cols`` is the warm block.
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
        if reuse == "pic" and sampling != "permutation":
            raise ValueError('reuse="pic" requires sampling="permutation" '
                             "(the cache is keyed by a fixed permutation)")
        self.k = int(k)
        self.metric = resolve_metric(metric)
        self.batch_size = int(batch_size)
        self.delta = delta
        self.max_swaps = max_swaps if max_swaps is not None else 4 * self.k + 10
        self.seed = seed
        self.sampling = sampling
        self.baseline = baseline
        self.swap_early_stop = bool(swap_early_stop)
        self.cache_cols = int(cache_cols)
        self.reuse = reuse
        self.cache_width = cache_width
        self.backend = backend
        self.fused = bool(fused)
        self.device = device

    # -- per-fit context -------------------------------------------------
    def _make_context(self, data, be_name: str, layouts,
                      res: FitReport) -> FitContext:
        """The fit's cache regime and buffers (``engine.FitContext``), and
        its tiles: resolved here, once a fit (``tuning``), for every
        launch of the fit."""
        n = data.shape[0]
        B = self.batch_size
        dev = data.device
        tiles = tuning.resolve_tile_config(
            n, data.shape[1], self.k, tuning.current_device_kind(dev),
            be_name)
        be = bind_stats_backend(be_name, tiles)
        if self.reuse == "pic":
            perm = _rng.as_device_index(layouts.fixed_perm(n), dev)
            W = resolve_cache_rounds(-(-n // B), B, self.cache_width)
            width = W * B
            # The cyclic tiling's prefix at the ring's width; positions
            # past n are weight-0 padding.
            perm_idx = perm.repeat(-(-width // n))[:width]
            perm_w = (torch.arange(width, device=dev) < n).to(torch.float32)
            cache = make_cache(n, B, W, dev)
            warm = min(min(self.cache_cols, n) // B, W)
            if warm > 0:
                # The warm block fills the ring's first rounds up front.
                stream_columns(be, data, data[perm_idx[:warm * B]],
                               metric=self.metric,
                               out=cache.cols[:, :warm * B])
                cache.hw, cache.fresh_pos = warm, warm * B
                res.evals_by_phase["cache_warm"] = n * warm * B
            return FitContext(mode="pic", backend=be_name, perm=perm,
                              perm_idx=perm_idx, perm_w=perm_w, cache=cache,
                              tiles=tiles)
        c = (min(self.cache_cols, n) // B) * B
        if c > 0 and self.sampling == "permutation":
            # Paper App 2.2: the first C columns of one fixed permutation.
            perm = _rng.as_device_index(layouts.fixed_perm(n), dev)
            dwarm = stream_columns(be, data, data[perm[:c]],
                                   metric=self.metric)
            res.evals_by_phase["cache_warm"] = n * c
            return FitContext(mode="warm", backend=be_name, perm=perm,
                              dwarm=dwarm, free_rounds=c // B, tiles=tiles)
        return FitContext(mode="none", backend=be_name, tiles=tiles)

    def _cached_block(self, be, data, ref_idx, rnd: int, ctx: FitContext,
                      run=None):
        """Round ``rnd``'s ``[n, B]`` distance block from the context's
        cache (PIC: from the ring, or fresh, a new round written straight
        into its slot under the round's flag ``run``), or None for a fresh
        fused round (warm mode past the warm block)."""
        B = self.batch_size
        if ctx.mode == "warm":
            if rnd >= ctx.free_rounds:
                return None
            return ctx.dwarm[:, rnd * B:(rnd + 1) * B]
        return search_read_or_write(be, data, ref_idx, metric=self.metric,
                                    batch_size=B, rnd=rnd, hw0=ctx.cache.hw,
                                    cache=ctx.cache, run=run)

    def _search_kw(self, layouts, phase: str, s: int, n: int, dev,
                   ctx: FitContext) -> dict:
        """The batch source of search ``s`` of ``phase`` (its permutation,
        the fit's fixed one, or its per-round draws), the baseline, and
        the rounds the context's cache serves."""
        kw = dict(baseline=self.baseline)
        B = self.batch_size
        if ctx.mode == "pic":
            W = ctx.cache.rounds_cap(B)
            kw.update(layout=cyclic_layout(ctx.perm, n, B), aux=ctx,
                      free_rounds=ctx.cache.hw,
                      free_lo=max(ctx.cache.hw - W, 0))
        elif ctx.mode == "warm":
            kw.update(layout=cyclic_layout(ctx.perm, n, B), aux=ctx,
                      free_rounds=ctx.free_rounds)
        elif self.sampling == "permutation":
            kw["layout"] = cyclic_layout(layouts.perm_on(phase, s, n, dev),
                                         n, B)
        else:
            kw["draw"] = lambda rnd: layouts.draw_on(phase, s, rnd, n, B,
                                                     dev)
        return kw

    # -- BUILD ----------------------------------------------------------
    def _build(self, data, ctx: FitContext, layouts, res: FitReport,
               resident: bool):
        """The k BUILD searches.  Each pick stays a device index: it
        updates the medoid mask and ``d_near`` on the device, so the
        phase reads its picks, rounds and ledger back once, at its end
        (plus the searches' own reads)."""
        n = data.shape[0]
        be = ctx.stats
        dev = data.device
        pic = ctx.mode == "pic"
        delta = self.delta if self.delta is not None else 1.0 / (1000.0 * n)
        log_term = log_term_f32(delta, dev)
        dnear = torch.full((n,), float("inf"), dtype=torch.float32,
                           device=dev)
        med_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        found, later = [], []   # later: searches charged at BUILD's end
        fresh0 = ctx.cache.fresh_pos if pic else 0
        for i in range(self.k):
            def stats_fn(ref_idx, w, lead, rnd=None, aux=None, run=None):
                dxy = (None if aux is None
                       else self._cached_block(be, data, ref_idx, rnd, aux,
                                               run))
                dnear_b = dnear.index_select(0, ref_idx)
                if dxy is None:
                    return be.build_stats(data, ref_idx, dnear_b, w, lead,
                                          metric=self.metric, run=run)
                return be.build_stats_from_d(dxy, dnear_b, w, lead)

            def exact_fn(run=None):
                return exact_build_means(be, data, dnear, metric=self.metric,
                                         run=run)

            kw = self._search_kw(layouts, "build", i, n, dev, ctx)
            # A search moves the ring's window only while hw is short of
            # the budget's last round; then the next search needs its
            # round count at once.  Past that the window stays put, and
            # the search's fresh rounds are charged with BUILD's end read.
            grows = pic and ctx.cache.hw < len(kw["layout"].sizes)
            sr = device_search(
                stats_fn=stats_fn, exact_fn=exact_fn,
                n_arms=n, n_ref=n, batch_size=self.batch_size,
                log_term=log_term, active_init=torch.logical_not(med_mask),
                resident=resident, rounds_to_host=grows, report=res,
                phase="build", **kw)
            if grows:
                search_advance(ctx.cache, ctx.cache.hw, 0, sr.rounds_h,
                               kw["layout"].sizes, self.batch_size)
            elif pic:
                later.append(i)
            best = sr.best.reshape(1)
            med_mask.index_fill_(0, best, True)
            dnear = torch.minimum(dnear, be.pairwise(
                data.index_select(0, best), data, metric=self.metric)[0])
            found.append(sr)
        k = self.k
        vals = host_read([s.best for s in found] + [s.rounds for s in found]
                         + [s.n_evals_cached if pic else s.n_evals
                            for s in found], res, "build")
        medoids = vals[:k]
        res.build_rounds.extend(vals[k:2 * k])
        if pic:
            for i in later:
                search_advance(ctx.cache, ctx.cache.hw, 0, vals[k + i],
                               kw["layout"].sizes, self.batch_size)
            # n per fresh column position.
            res.evals_by_phase["build"] = (n * (ctx.cache.fresh_pos - fresh0)
                                           + n * k)
            res.evals_by_phase["build_cached"] = sum(vals[2 * k:])
        else:
            res.evals_by_phase["build"] = sum(vals[2 * k:]) + n * k
        med_t = torch.stack([s.best for s in found])
        return medoids, med_t, med_mask

    # -- SWAP -----------------------------------------------------------
    def _swap(self, data, medoids, med_t, med_mask, ctx: FitContext,
              layouts, res: FitReport, resident: bool):
        """The SWAP iterations, each one search plus ONE read: the pick,
        the candidate loss, the accept bit (decided on the device) and the
        ledger terms.  The running loss stays on the device; the first one
        is read once."""
        n = data.shape[0]
        k = self.k
        B = self.batch_size
        be = ctx.stats
        dev = data.device
        pic = ctx.mode == "pic"
        delta = (self.delta if self.delta is not None
                 else 1.0 / (1000.0 * k * n))
        log_term = log_term_f32(delta, dev)
        prev_loss = total_loss(data, med_t, metric=self.metric,
                               backend=be)
        (loss,) = host_read([prev_loss], res, "swap")
        converged = False
        swap_evals = swap_cached = 0
        carry = None  # (sums, sqsums, rounds, d1, d2, assign) of last search

        def count_fn(active):
            # FastPAM1: one distance per (x, y) pair serves all k arms (·, x).
            return torch.sum(torch.any(active.view(k, n), dim=0),
                             dtype=torch.int64)

        for t in range(self.max_swaps):
            d1, d2, assign = medoid_cache(data, med_t, metric=self.metric,
                                          backend=be)
            seed = {}
            n_changed = torch.zeros((), dtype=torch.int64, device=dev)
            if carry is not None and carry_valid(ctx.cache, B):
                # Virtual arms: the last search's moments, repaired where
                # the accepted swap moved (d1, d2, assign).  Once a round
                # was recycled the search starts cold.
                c_sums, c_sq, c_rounds, d1o, d2o, ao = carry
                s0, q0, n_changed = _carry_delta(
                    be, ctx.cache.cols, ctx.perm_idx, ctx.perm_w,
                    c_rounds * B, d1o, d2o, ao, d1, d2, assign, c_sums, c_sq,
                    k)
                seed = dict(init_sums=s0, init_sqsums=q0,
                            init_rounds=c_rounds)

            def stats_fn(ref_idx, w, lead, rnd=None, aux=None, run=None):
                dxy = (None if aux is None
                       else self._cached_block(be, data, ref_idx, rnd, aux,
                                               run))
                d1_b, d2_b, a_b = (v.index_select(0, ref_idx)
                                   for v in (d1, d2, assign))
                if dxy is None:
                    return be.swap_stats(data, ref_idx, d1_b, d2_b, a_b, w,
                                         k, lead, metric=self.metric,
                                         run=run)
                return be.swap_stats_from_d(dxy, d1_b, d2_b, a_b, w, k, lead,
                                            run=run)

            def exact_fn(run=None):
                return exact_swap_means(be, data, d1, d2, assign, k,
                                        metric=self.metric, run=run)

            kw = self._search_kw(layouts, "swap", t, n, dev, ctx)
            sr = device_search(
                stats_fn=stats_fn, exact_fn=exact_fn,
                n_arms=k * n, n_ref=n, batch_size=B,
                log_term=log_term,
                active_init=torch.logical_not(med_mask).repeat(k),
                count_fn=count_fn, stop_when_positive=self.swap_early_stop,
                resident=resident, report=res, phase="swap", **seed, **kw)
            cand = med_t.index_copy(0, (sr.best // n).reshape(1),
                                    (sr.best % n).reshape(1))
            new_loss = total_loss(data, cand, metric=self.metric,
                                  backend=be)
            # The JAX package's accept rule, float32 on the device.
            accept = new_loss < prev_loss - 1e-7 * torch.clamp_min(
                torch.abs(prev_loss), 1.0)
            # The iteration's one read, with the fallback flag where the
            # resident loop decided it on the device.
            used = sr.used_exact
            (best_h, new_loss_h, accept_h, n_evals_h, n_cached_h,
             n_changed_h, rounds_h, *used_h) = host_read(
                 [sr.best, new_loss, accept, sr.n_evals, sr.n_evals_cached,
                  n_changed, sr.rounds]
                 + ([used] if torch.is_tensor(used) else []), res, "swap")
            res.swap_exact_fallbacks += int(used_h[0] if used_h else used)
            if pic:
                # Fresh: n per fresh column position; cached: the rounds
                # served from the ring plus n per repaired point.
                fresh0 = ctx.cache.fresh_pos
                search_advance(ctx.cache, ctx.cache.hw, seed.get(
                    "init_rounds", 0), rounds_h, kw["layout"].sizes, B)
                swap_evals += 2 * n * k + n * (ctx.cache.fresh_pos - fresh0)
                swap_cached += n_cached_h + n * n_changed_h
                carry = (sr.sums, sr.sqsums, rounds_h, d1, d2, assign)
            else:
                swap_evals += 2 * n * k + n_evals_h
            if not accept_h:
                converged = True
                break
            m_idx, x_idx = divmod(best_h, n)
            old = medoids[m_idx]
            medoids[m_idx] = x_idx
            # The mask moves by the device indices: a host index would be
            # copied to the device and wait for it.
            med_mask.index_fill_(0, med_t[m_idx:m_idx + 1], False)
            med_mask.index_fill_(0, cand[m_idx:m_idx + 1], True)
            med_t = cand
            res.swap_history.append((old, x_idx, new_loss_h))
            loss = new_loss_h
            prev_loss = new_loss
        res.evals_by_phase["swap"] = swap_evals
        if pic:
            res.evals_by_phase["swap_cached"] = swap_cached
        return medoids, loss, converged

    # -- public ----------------------------------------------------------
    def fit(self, data, warm_start=None, layouts=None) -> FitReport:
        """Fit medoids on ``data`` ([n, d], numpy or tensor).

        ``warm_start`` (k distinct indices into ``data``) skips BUILD and
        starts SWAP from those medoids: the serving layer's refit.  BUILD
        pays 0 evaluations, the fixed permutation of a cache regime is
        drawn as in a cold fit, and the SWAP searches take the chain's
        subkeys from its head, as in the JAX package.

        ``layouts`` is the source of the per-search reference
        permutations or replacement draws (``repro_torch.core.rng``); by
        default the JAX package's threefry chain for ``self.seed``,
        computed on the fit's device.
        """
        return self._fit(data, warm_start, layouts)[0]

    def _fit(self, data, warm_start=None, layouts=None):
        """:meth:`fit`, returning the report and the fit's context."""
        dev = resolve_device(self.device)
        with host_stage("the fit's data"):
            data = torch.as_tensor(data, dtype=torch.float32).to(
                dev).contiguous()
        if data.ndim != 2:
            raise ValueError(f"expected [n, d] data, got {tuple(data.shape)}")
        n = data.shape[0]
        if n <= self.k:
            raise ValueError("need n > k")
        ws = None
        if warm_start is not None:
            ws = np.asarray(warm_start, np.int64).ravel()
            if ws.shape[0] != self.k or len(set(ws.tolist())) != self.k:
                raise ValueError(
                    f"warm_start must be {self.k} distinct medoid indices, "
                    f"got {ws.tolist()}")
            if ws.min() < 0 or ws.max() >= n:
                raise ValueError(f"warm_start indices out of range [0, {n})")
        check_data(data, self.metric)
        be_name = resolve_stats_backend(self.backend, self.metric, dev)
        if layouts is None:
            # A warm fit runs no BUILD search before its SWAP searches.
            layouts = _rng.from_seed(self.seed, dev,
                                     self.k if ws is None else 0)
        res = FitReport(medoids=np.zeros(self.k, np.int64), loss=np.inf,
                        n_swaps=0, converged=False, distance_evals=0)
        ctx = self._make_context(data, be_name, layouts, res)
        phase_sync(dev)
        t0 = time.perf_counter()
        # The device-resident searches run every mode but one: replacement
        # draws taken from one generator in consumption order, where a
        # round enqueued past a search's stop would use up the draws of
        # the searches after it.
        resident = self.fused and not (
            self.sampling == "replacement"
            and isinstance(layouts, _rng.GeneratorLayouts))
        if ws is None:
            medoids, med_t, med_mask = self._build(data, ctx, layouts, res,
                                                   resident)
        else:
            medoids = ws.tolist()
            with host_stage("the warm-start medoids"):
                med_t = torch.as_tensor(ws).to(dev)
            med_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
            med_mask.index_fill_(0, med_t, True)
            res.evals_by_phase["build"] = 0
        phase_sync(dev)
        res.wall_by_phase["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        medoids, loss, converged = self._swap(data, medoids, med_t, med_mask,
                                              ctx, layouts, res, resident)
        phase_sync(dev)
        res.wall_by_phase["swap"] = time.perf_counter() - t0
        res.medoids = np.asarray(medoids, np.int64)
        res.loss = loss
        res.n_swaps = len(res.swap_history)
        res.converged = converged
        res.distance_evals = sum(v for ph, v in res.evals_by_phase.items()
                                 if not ph.endswith("_cached"))
        res.cached_evals = sum(v for ph, v in res.evals_by_phase.items()
                               if ph.endswith("_cached"))
        # Feed the measured phase walls back to the tile tuner: the next
        # resolve of this (n, d, k, device, backend) bucket prefers the
        # fastest observed config over the wave model.
        tuning.observe(n, data.shape[1], self.k, ctx.tiles,
                       res.wall_by_phase, tuning.current_device_kind(dev),
                       be_name)
        return res, ctx

    def fit_batch(self, datasets, seeds=None):
        """Fit a batch of INDEPENDENT datasets (``core/batch.py``).

        ``datasets`` is a ``[B, n, d]`` array or tensor, or a list of
        ``[n_i, d]`` ones with ragged ``n_i``; ``seeds`` the per-fit seeds
        (default: ``self.seed`` for every fit).  Each fit equals
        ``BanditPAM(seed=seeds[i]).fit(datasets[i])`` bit for bit:
        medoids, loss, swap history, build rounds and ledger.  Needs
        ``sampling="permutation"`` and ``cache_cols=0``.  Returns a
        :class:`~repro_torch.core.report.BatchFitReport`.
        """
        from .batch import fit_batch
        return fit_batch(self, datasets, seeds)

    def fit_predict(self, data) -> np.ndarray:
        """Fit and return the in-sample labels, ``[n]`` int32: each
        point's nearest medoid (first index on ties), one top-2 pass
        through the fit's stats backend."""
        res = self.fit(data)
        dev = resolve_device(self.device)
        with host_stage("the labels' data and medoids"):
            data = torch.as_tensor(data, dtype=torch.float32).to(
                dev).contiguous()
            med = torch.as_tensor(res.medoids).to(dev)
        be_name = resolve_stats_backend(self.backend, self.metric, dev)
        _, _, assign = medoid_cache(data, med, metric=self.metric,
                                    backend=be_name)
        return assign.cpu().numpy()
