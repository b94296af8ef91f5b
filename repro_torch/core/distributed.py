"""Distributed BanditPAM on ``torch.distributed``: data-sharded references,
replicated arms (counterpart of ``repro.core.distributed``).

One process per shard.  Where the JAX package takes a ``Mesh`` the port
takes a process group (``group``); the shard index is the rank in it.
The JAX ``(pod, data)`` mesh flattens to ``pod·m2 + data``, a flat rank
order, so one flat group covers both mesh shapes.  Every rank calls
``fit(data)`` with the full ``[n, d]`` data (replicated, as the JAX
``data_f``) and returns the same :class:`~repro_torch.core.report.FitReport`.

* **Shards.** Rank ``ax`` owns rows ``[ax·n_loc, (ax+1)·n_loc)`` of the
  view padded to a shard multiple with cyclic copies,
  ``data[arange(n_pad) % n]`` (real points, so every metric stays
  NaN-free); ``n_loc = ceil(n/S)``.  Padding rows lie past the shard's
  valid rows ``v = clip(n − ax·n_loc, 0, n_loc)`` and never reach the
  statistics or the loss.
* **Replacement sampling (``reuse="none"``), stratified.** Every round
  each rank draws ``b_loc = B/S`` uniform indices into its valid rows
  (``randint(fold_in(fold_in(fold_in(PRNGKey(seed ^ tag), step), rnd),
  ax), (b_loc,), 0, max(v, 1))``, the port's threefry, the JAX draws bit
  for bit) and weights its statistics by its stratum, ``cs = v·S/n`` in
  float32 (``cs²`` for the square and cross sums), so the estimator of
  the mean stays unbiased under uneven strata; an all-padding shard
  weighs 0.  The search's own draw is this rank's draw; its count is B.
* **The collective.** Each rank computes the per-arm (Σg, Σg², Σg·g_lead)
  of ALL arms against its own draw through the stats backend: one
  ``pairwise`` block ``[n, b_loc]`` and the backend's from-distances
  statistics (``swap_g_from_cache`` on the card for SWAP).  One
  ``all_reduce(SUM)`` of the stacked three per bandit round composes
  them, where the JAX package has its ``psum``; the reduced bits are the
  same on every rank, so the arm elimination, run redundantly on every
  rank, stops every rank at the same round.  No backend owns a
  collective.
* **PIC (``reuse="pic"``).** Each rank walks a fixed permutation of its
  own ``n_loc`` rows, ``permutation(fold_in(ckey, ax), n_loc)`` with
  ``key, ckey = split(PRNGKey(seed))``; round r is slice
  ``[r·b_loc, (r+1)·b_loc)`` of every rank's walk, positions past
  ``n_loc`` or onto padding rows weigh 0.  The search runs over the
  global layout (round r at slots ``[r·B, (r+1)·B)``, rank s owning the
  sub-slice ``[s·b_loc, (s+1)·b_loc)``) as an explicit
  :class:`~repro_torch.core.adaptive.Layout`: weight-0 padding falls
  into early rounds, so a round counts its weights.  Each rank holds the
  ``[n, W·b_loc]`` ring of the columns its own rows produce.  After an
  accepted swap the carried per-arm moments are repaired from each
  rank's ring, with one more all-reduce (the JAX ``_carry_smap``).
* **The loops** (``fused``).  ``fused=True`` (the default, the JAX
  sharded fit's way: no host read inside a phase) runs the
  device-resident searches in both modes: every round is enqueued with
  the search's device flag, and the host reads the flag once every
  ``adaptive.ROUNDS_PER_READ`` rounds.  A round enqueued past the stop
  still makes its all-reduce (its reduced statistics are discarded on
  the device), and the flag comes from reduced statistics, bit for bit
  the same on every rank, so every rank enqueues the same rounds and
  the same collectives and reads at the same rounds.  The rank's ring
  moves a search at a time, as the single fit's
  (``pic_cache.search_read_or_write`` / ``search_advance``), and
  replacement's exact fallback runs under its device flag.
  ``fused=False`` steps: one host read a round, the ring moved a round
  at a time (``pic_cache.shard_slot_read_write`` / ``cache_advance``).
  Both give the same report bit for bit.  The leader baseline is always
  on.  BUILD updates ``d_near`` with one ``pairwise`` row a pick; SWAP
  refreshes the medoid cache and scores the candidate with ``top2``
  (``engine.medoid_cache`` / ``total_loss``); the exact fallback walks
  the full replicated data (``stream_build_g`` / ``stream_swap_g`` on
  the card).  The accept rule is the JAX sharded fit's, on the host:
  ``new < prev − 1e-7·max(1, |prev|)`` in float64 over the float32
  losses.
* **Without a group** (``torch.distributed`` not initialised, and no
  ``group=``) the fit runs one shard and skips the collective, as the
  JAX ``psum`` over a one-device axis does.

``host_reads_by_phase`` counts the fit's reads as every port fit does;
:func:`allreduce_counts` counts the all-reduces by phase (every rank
makes the same ones: one a round enqueued, masked rounds included, and
one a carried repair).  :func:`spawn_fits` runs fits on ranks of a
``gloo`` group, each a process of this host (on the CPU, or several on
one card).  ``MedoidCurator`` is the JAX package's curation entry point.
"""

from __future__ import annotations

import datetime
import multiprocessing
import socket
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import threefry, tuning
from .adaptive import device_search, explicit_layout, log_term_f32
from .banditpam import BanditPAM, _repair_weights
from .device import DeviceLike, resolve_device
from .distances import check_data, resolve_metric
from .engine import (bind_stats_backend, exact_build_means,
                     exact_swap_means, host_read, host_stage, medoid_cache,
                     phase_sync, resolve_stats_backend, total_loss)
from .pic_cache import (cache_advance, carry_valid, make_cache,
                        resolve_cache_rounds, search_advance,
                        search_read_or_write, shard_slot_read_write,
                        to_device)
from .report import FitReport

__all__ = ["DistributedBanditPAM", "MedoidCurator", "RankFit",
           "allreduce_counts", "data_group", "default_group",
           "reset_allreduce_counts", "spawn_fits"]

_BUILD_TAG = 0x5EED
_SWAP_TAG = 0x50A9

# Rounds of one search's stratified draws computed per threefry pass: a
# search that stops early computes no more than a chunk past its stop.
DRAW_CHUNK = 32

# All-reduces per phase, counted where they are issued.
_ALLREDUCES: Dict[str, int] = {}


def allreduce_counts() -> Dict[str, int]:
    """All-reduces by phase (``build``, ``swap``; the carried repair's
    under ``swap``) since the last :func:`reset_allreduce_counts`."""
    return dict(_ALLREDUCES)


def reset_allreduce_counts() -> None:
    _ALLREDUCES.clear()


def data_group(mesh):
    """The group of a ``DeviceMesh``'s data shards for this rank: its
    ``pod`` and ``data`` dimensions flattened, pod major (the flat order
    above); the ranks along ``model`` each get a group of their own, so
    they hold the same shard (the JAX ``_data_axes``)."""
    names = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if not names:
        raise ValueError(f"mesh has no data axes; axis names must include "
                         f"'data' (and optionally 'pod'), got "
                         f"{mesh.mesh_dim_names}")
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def default_group():
    """The WORLD group when ``torch.distributed`` is initialised, else
    None (one shard, no collective): the counterpart of the JAX
    package's ``default_mesh``."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


# ---------------------------------------------------------------------------
# The stratified sampler's key chain: PRNGKey(seed ^ phase tag) ->
# fold(selection / iteration) -> fold(round) -> fold(shard), the JAX
# package's, on the port's threefry (keys are host ints).
# ---------------------------------------------------------------------------

def _phase_key(seed: int, tag: int, step: int) -> threefry.Key:
    """Base key of one bandit search: ``step`` is the BUILD selection or
    the SWAP iteration."""
    return threefry.fold_in(threefry.PRNGKey(int(seed) ^ tag), step)


def _round_key(phase_key: threefry.Key, rnd: int) -> threefry.Key:
    return threefry.fold_in(phase_key, rnd)


def _shard_draws(round_key: threefry.Key, ax: int, n_valid: int, b_loc: int,
                 device="cpu") -> torch.Tensor:
    """Shard ``ax``'s draw of one round: ``b_loc`` uniform indices into
    its valid rows (``max(n_valid, 1)`` for an all-padding shard, whose
    weight is 0)."""
    return threefry.randint(threefry.fold_in(round_key, ax), (b_loc,), 0,
                            max(n_valid, 1), device)


class _Draws:
    """This rank's draws for one search, ``rnd -> [b_loc]`` int64 on the
    device, computed ``DRAW_CHUNK`` rounds per threefry pass; each row is
    :func:`_shard_draws`'."""

    def __init__(self, phase_key, ax: int, n_valid: int, b_loc: int,
                 device):
        self.args = (phase_key, ax, max(n_valid, 1), b_loc, device)
        self.chunk = (-1, None)

    def __call__(self, rnd: int) -> torch.Tensor:
        pk, ax, hi, b_loc, device = self.args
        c = rnd // DRAW_CHUNK
        if self.chunk[0] != c:
            keys = [threefry.fold_in(_round_key(pk, r), ax)
                    for r in range(c * DRAW_CHUNK, (c + 1) * DRAW_CHUNK)]
            self.chunk = (c, threefry.randint_rows(keys, b_loc, 0, hi,
                                                   device))
        return self.chunk[1][rnd % DRAW_CHUNK]


def _pic_layout(n: int, n_shards: int, b_loc: int, ckey: threefry.Key):
    """The ``reuse="pic"`` schedule of every shard, on the host:
    ``lperm`` / ``lw`` ``[S, R_max·b_loc]`` (each shard's walk, tiled
    from its fixed permutation, and its {0,1} weights) and the global
    layout ``perm_idx_g`` / ``perm_w_g`` ``[R_max·B]`` (round-major, shard
    sub-slices in rank order), as the JAX ``_pic_layout`` builds them."""
    S = n_shards
    n_loc = -(-n // S)
    r_max = -(-n_loc // b_loc)
    width = r_max * b_loc
    perms = threefry.permutations(
        [threefry.fold_in(ckey, s) for s in range(S)], n_loc).numpy()
    tiled = np.tile(perms, (1, -(-width // n_loc)))[:, :width]
    v = np.clip(n - np.arange(S) * n_loc, 0, n_loc)[:, None]
    lw = ((np.arange(width)[None, :] < n_loc) & (tiled < v)).astype(
        np.float32)
    gidx = np.minimum(np.arange(S)[:, None] * n_loc + tiled, n - 1)

    def to_global(a):
        return a.reshape(S, r_max, b_loc).transpose(1, 0, 2).reshape(-1)

    return tiled, lw, to_global(gidx), to_global(lw)


class DistributedBanditPAM:
    """BanditPAM over a sharded reference set (see the module docstring).

    ``group`` is the process group whose ranks are the shards (default:
    :func:`default_group`), or ``mesh=`` a ``DeviceMesh`` whose data
    axes are (:func:`data_group`); every rank calls :meth:`fit` with the
    same data.  ``batch_size`` (B, default 128) is rounded up to a multiple of
    the shard count.  ``device=None`` is the card (each rank's current
    CUDA device); ``device="cpu"`` runs the plain path.  ``backend`` is a
    stats backend (``"auto"``, ``"cuda"``, ``"torch"``); ``reuse="pic"``
    runs the sharded PIC ring, ``cache_width`` its width in global
    reference columns (default 32 rounds).  ``fused=False`` runs the
    stepped loop (see the module docstring).  Seeds are not comparable with
    :class:`~repro_torch.core.banditpam.BanditPAM`'s: the schedule is
    stratified per shard.
    """

    def __init__(self, k: int, group=None, metric: str = "l2",
                 batch_size: int = 128, delta: Optional[float] = None,
                 max_swaps: Optional[int] = None, seed: int = 0,
                 backend: str = "auto", reuse: str = "none",
                 cache_width: Optional[int] = None, fused: bool = True,
                 device: DeviceLike = None, mesh=None):
        if reuse not in ("none", "pic"):
            raise ValueError(f"unknown reuse mode {reuse!r}")
        if mesh is not None:
            if group is not None:
                raise ValueError("pass a group or a mesh, not both")
            group = data_group(mesh)
        self.k = int(k)
        self.group = default_group() if group is None else group
        if self.group is None:
            self.n_shards, self.ax = 1, 0
        else:
            self.n_shards = dist.get_world_size(self.group)
            self.ax = dist.get_rank(self.group)
            if self.ax < 0:
                raise ValueError("this process is not a rank of the group")
        self.metric = resolve_metric(metric)
        batch_size = int(batch_size)
        if batch_size % self.n_shards:
            batch_size += self.n_shards - batch_size % self.n_shards
        self.batch_size = batch_size
        self.delta = delta
        self.max_swaps = max_swaps if max_swaps is not None else 4 * self.k + 10
        self.seed = seed
        self.backend = backend
        self.reuse = reuse
        self.cache_width = cache_width
        self.fused = fused
        self.device = device

    # -- this rank's view -------------------------------------------------
    def _n_loc(self, n: int) -> int:
        return -(-n // self.n_shards)

    def _stratum(self, n: int) -> Tuple[int, float]:
        """(valid rows, stratum weight ``v·S/n``) of this rank, the weight
        in float32 in the JAX package's order of operations."""
        n_loc = self._n_loc(n)
        v = min(max(n - self.ax * n_loc, 0), n_loc)
        cs = np.float32(v) * np.float32(self.n_shards) / np.float32(n)
        return v, float(cs)

    def _reduce(self, phase: str, *parts: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``parts`` (stacked): one all-reduce."""
        out = torch.cat([p.reshape(-1) for p in parts])
        if self.group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
            _ALLREDUCES[phase] = _ALLREDUCES.get(phase, 0) + 1
        return out

    # -- fit ----------------------------------------------------------------
    def fit(self, data) -> FitReport:
        return self._fit(data)[0]

    def _fit(self, data) -> Tuple[FitReport, "_Fit"]:
        """:meth:`fit`, returning the report and this rank's fit state
        (its ring under ``reuse="pic"``)."""
        dev = resolve_device(self.device)
        with host_stage("the fit's data"):
            data = torch.as_tensor(data, dtype=torch.float32).to(
                dev).contiguous()
        if data.ndim != 2:
            raise ValueError(f"expected [n, d] data, got {tuple(data.shape)}")
        n = data.shape[0]
        if n <= self.k:
            raise ValueError("need n > k")
        check_data(data, self.metric)
        be_name = resolve_stats_backend(self.backend, self.metric, dev)
        res = FitReport(medoids=np.zeros(self.k, np.int64), loss=np.inf,
                        solver="banditpam_dist", metric=str(self.metric))
        f = _Fit(self, data, be_name, res)
        phase_sync(dev)
        t0 = time.perf_counter()
        med_t, med_mask = f.build()
        phase_sync(dev)
        res.wall_by_phase["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f.swap(med_t, med_mask)
        phase_sync(dev)
        res.wall_by_phase["swap"] = time.perf_counter() - t0
        res.n_swaps = len(res.swap_history)
        res.distance_evals = sum(v for ph, v in res.evals_by_phase.items()
                                 if not ph.endswith("_cached"))
        res.cached_evals = sum(v for ph, v in res.evals_by_phase.items()
                               if ph.endswith("_cached"))
        return res, f


class _Fit:
    """One rank's state through one fit: its rows, draws or PIC walk and
    ring, and the phases."""

    def __init__(self, est: DistributedBanditPAM, data: torch.Tensor,
                 be_name: str, res: FitReport):
        self.est, self.data, self.res = est, data, res
        self.be_name = be_name
        self.metric = est.metric
        self.k = est.k
        self.n = n = data.shape[0]
        # The fit's tiles, resolved once through the tuner (keyed on the
        # full n: every rank computes every arm's statistics); the
        # sharded fit does not observe, as in the JAX package.
        self.be = bind_stats_backend(be_name, tuning.resolve_tile_config(
            n, data.shape[1], est.k, tuning.current_device_kind(data.device),
            be_name))
        dev = self.dev = data.device
        S, ax = est.n_shards, est.ax
        self.B = est.batch_size
        self.b_loc = self.B // S
        self.n_loc = n_loc = est._n_loc(n)
        self.v, self.cs = est._stratum(n)
        self.cs2 = float(np.float32(self.cs) * np.float32(self.cs))
        self.pic = est.reuse == "pic"
        self.resident = bool(est.fused)
        if self.pic:
            _, ckey = threefry.split(threefry.PRNGKey(est.seed))
            lperm, lw, pidx_g, pw_g = _pic_layout(n, S, self.b_loc, ckey)
            self.layout = explicit_layout(pidx_g, pw_g, self.B, dev)
            r_max = lperm.shape[1] // self.b_loc
            self.W = resolve_cache_rounds(r_max, self.B, est.cache_width)
            own = ax * n_loc + lperm[ax]
            # Row of the padded view (data_l[lidx]) and its index into the
            # replicated per-point vectors, for every walk position.
            self.src_l = to_device(own % n, torch.int64, dev)
            self.gidx_l = to_device(np.minimum(own, n - 1), torch.int64, dev)
            self.lw_l = to_device(lw[ax], torch.float32, dev)
            self.ring = make_cache(n, self.b_loc, self.W, dev)
        else:
            self.ones = torch.ones((self.b_loc,), dtype=torch.float32,
                                   device=dev)

    # -- one round's statistics on this rank, reduced over the ranks ------
    def _block(self, src: torch.Tensor, run=None) -> torch.Tensor:
        """``pairwise(data, data[src])``, ``[n, b]``, under the round's
        flag ``run``."""
        return self.be.pairwise(self.data, self.data.index_select(0, src),
                                metric=self.metric, run=run)

    def _round(self, ref_idx, rnd: int, hw0: int, run=None):
        """Round ``rnd``'s block on this rank, the points' indices into
        the per-point vectors and their weights.  Replacement: the drawn
        rows ``ax·n_loc + ref_idx`` of the padded view (``gidx = min(·,
        n − 1)``).  PIC: the rank's ring, read a round at a time in the
        stepped loop and from the search's start ``hw0`` in the resident
        one (a NEW round written into its slot under its flag)."""
        if not self.pic:
            own = self.est.ax * self.n_loc + ref_idx
            return (self._block(own % self.n, run),
                    torch.clamp_max(own, self.n - 1), self.ones)
        lo, b = rnd * self.b_loc, self.b_loc
        src = self.src_l[lo:lo + b]
        if self.resident:
            dxy = search_read_or_write(self.be, self.data, src,
                                       metric=self.metric, batch_size=b,
                                       rnd=rnd, hw0=hw0, cache=self.ring,
                                       run=run)
        else:
            dxy = shard_slot_read_write(self.ring.cols, rnd, self.ring.hw, b,
                                        lambda: self._block(src))
        return dxy, self.gidx_l[lo:lo + b], self.lw_l[lo:lo + b]

    def _finish(self, phase: str, rnd: int, s, q, c) -> Tuple:
        """The round's one all-reduce (a masked round's too); the stepped
        loop moves the ring past the round."""
        if self.pic:
            out = self.est._reduce(phase, s, q, c)
            if not self.resident:
                cache_advance(self.ring, rnd, self.layout.sizes[rnd], self.W)
        else:
            # The stratum weights, applied before the reduce.
            out = self.est._reduce(phase, s * self.cs, q * self.cs2,
                                   c * self.cs2)
        return tuple(out.view(3, -1))

    def _advance(self, hw0: int, r0: int, r_end: int) -> None:
        """The resident loop's ring after a search from ``hw0`` ran rounds
        ``[r0, r_end)`` (the stepped loop moved it a round at a time)."""
        if self.pic and self.resident:
            search_advance(self.ring, hw0, r0, r_end, self.layout.sizes,
                           self.b_loc)

    def _search_kw(self, phase: str, step: int) -> dict:
        if self.pic:
            W, hw = self.W, self.ring.hw
            return dict(layout=self.layout, aux=self.ring, free_rounds=hw,
                        free_lo=max(hw - W, 0))
        tag = _BUILD_TAG if phase == "build" else _SWAP_TAG
        return dict(draw=_Draws(_phase_key(self.est.seed, tag, step),
                                self.est.ax, self.v, self.b_loc, self.dev))

    # -- BUILD ------------------------------------------------------------
    def build(self):
        n, k, be, res = self.n, self.k, self.be, self.res
        est, dev = self.est, self.dev
        delta = est.delta if est.delta is not None else 1.0 / (1000.0 * n)
        log_term = log_term_f32(delta, dev)
        dnear = torch.full((n,), float("inf"), dtype=torch.float32,
                           device=dev)
        med_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        found, later = [], []   # later: searches whose ring moves at the end
        fresh0 = self.ring.fresh_pos if self.pic else 0
        for i in range(k):
            hw0 = self.ring.hw if self.pic else 0

            def stats_fn(ref_idx, w, lead, rnd=None, aux=None, run=None):
                dxy, gidx, wl = self._round(ref_idx, rnd, hw0, run)
                s, q, c = be.build_stats_from_d(
                    dxy, dnear.index_select(0, gidx), wl, lead)
                return self._finish("build", rnd, s, q, c)

            def exact_fn(run=None):
                return exact_build_means(be, self.data, dnear,
                                         metric=self.metric, run=run)

            # As in the single fit: while hw is short of the budget's last
            # round the next search needs this one's round count at once;
            # past that the window stays put until BUILD's end read.
            grows = self.pic and hw0 < len(self.layout.sizes)
            sr = device_search(
                stats_fn=stats_fn, exact_fn=exact_fn, n_arms=n, n_ref=n,
                batch_size=self.B, log_term=log_term,
                active_init=torch.logical_not(med_mask), baseline="leader",
                resident=self.resident, rounds_to_host=grows, report=res,
                phase="build", **self._search_kw("build", i))
            if grows:
                self._advance(hw0, 0, sr.rounds_h)
            elif self.pic:
                later.append(i)
            best = sr.best.reshape(1)
            med_mask.index_fill_(0, best, True)
            dnear = torch.minimum(dnear, be.pairwise(
                self.data.index_select(0, best), self.data,
                metric=self.metric)[0])
            found.append(sr)
        vals = host_read([s.best for s in found] + [s.rounds for s in found]
                         + [s.n_evals_cached if self.pic else s.n_evals
                            for s in found], res, "build")
        res.build_rounds.extend(vals[k:2 * k])
        for i in later:
            self._advance(self.ring.hw, 0, vals[k + i])
        if self.pic:
            # n per fresh column position, on host ints.
            res.evals_by_phase["build"] = (n * (self.ring.fresh_pos - fresh0)
                                           + n * k)
            res.evals_by_phase["build_cached"] = sum(vals[2 * k:])
        else:
            res.evals_by_phase["build"] = sum(vals[2 * k:]) + n * k
        self.medoids = vals[:k]
        return torch.stack([s.best for s in found]), med_mask

    # -- SWAP -------------------------------------------------------------
    def _carry(self, carry, d1, d2, assign):
        """The carried moments repaired against the new medoid cache from
        this rank's ring over its own changed prefix positions, composed
        over the ranks by one all-reduce (the JAX ``_carry_smap``):
        ``(init_sums, init_sqsums, n_changed)``."""
        k, cols = self.k, self.ring.cols
        c_sums, c_sq, c_rounds, d1o, d2o, ao = carry
        width = self.W * self.b_loc
        w, b, c = _repair_weights(self.gidx_l[:width], self.lw_l[:width],
                                  c_rounds * self.b_loc, (d1o, d2o, ao),
                                  (d1, d2, assign))
        s_old, q_old, _ = self.be.swap_stats_from_d(cols, *b, w, k, None)
        s_new, q_new, _ = self.be.swap_stats_from_d(cols, *c, w, k, None)
        out = self.est._reduce("swap", s_new - s_old, q_new - q_old,
                               torch.sum(w).view(1))
        kn = s_new.numel()
        return (c_sums + out[:kn], c_sq + out[kn:2 * kn],
                out[2 * kn].to(torch.int64))

    def swap(self, med_t, med_mask):
        n, k, be, res, est = self.n, self.k, self.be, self.res, self.est
        metric, dev = self.metric, self.dev
        delta = (est.delta if est.delta is not None
                 else 1.0 / (1000.0 * k * n))
        log_term = log_term_f32(delta, dev)
        medoids = list(self.medoids)
        (loss,) = host_read([total_loss(self.data, med_t, metric=metric,
                                        backend=self.be)], res, "swap")
        swap_evals = swap_cached = 0
        converged = False
        carry = None  # (sums, sqsums, rounds, d1, d2, assign) of last search

        def count_fn(active):
            # FastPAM1: one distance per (x, y) pair serves all k arms (·, x).
            return torch.sum(torch.any(active.view(k, n), dim=0),
                             dtype=torch.int64)

        for t in range(est.max_swaps):
            d1, d2, assign = medoid_cache(self.data, med_t, metric=metric,
                                          backend=self.be)
            seed = {}
            n_changed = torch.zeros((), dtype=torch.int64, device=dev)
            if carry is not None and carry_valid(self.ring, self.b_loc):
                # Once a round was recycled the search starts cold.
                s0, q0, n_changed = self._carry(carry, d1, d2, assign)
                seed = dict(init_sums=s0, init_sqsums=q0,
                            init_rounds=carry[2])

            def stats_fn(ref_idx, w, lead, rnd=None, aux=None, run=None):
                dxy, gidx, wl = self._round(ref_idx, rnd, hw0, run)
                s, q, c = be.swap_stats_from_d(
                    dxy, d1.index_select(0, gidx), d2.index_select(0, gidx),
                    assign.index_select(0, gidx), wl, k, lead, run=run)
                return self._finish("swap", rnd, s, q, c)

            def exact_fn(run=None):
                return exact_swap_means(be, self.data, d1, d2, assign, k,
                                        metric=metric, run=run)

            fresh0 = self.ring.fresh_pos if self.pic else 0
            hw0 = self.ring.hw if self.pic else 0
            sr = device_search(
                stats_fn=stats_fn, exact_fn=exact_fn, n_arms=k * n, n_ref=n,
                batch_size=self.B, log_term=log_term,
                active_init=torch.logical_not(med_mask).repeat(k),
                count_fn=count_fn, baseline="leader", resident=self.resident,
                report=res, phase="swap", **seed,
                **self._search_kw("swap", t))
            cand = med_t.index_copy(0, (sr.best // n).reshape(1),
                                    (sr.best % n).reshape(1))
            new_loss = total_loss(self.data, cand, metric=metric,
                                  backend=self.be)
            # The iteration's one read, with the fallback flag where the
            # resident loop decided it on the device.
            used = sr.used_exact
            best, new_loss, n_evals, n_cached, n_chg, rounds, *used_h = (
                host_read([sr.best, new_loss, sr.n_evals, sr.n_evals_cached,
                           n_changed, sr.rounds]
                          + ([used] if torch.is_tensor(used) else []),
                          res, "swap"))
            res.swap_exact_fallbacks += int(used_h[0] if used_h else used)
            if self.pic:
                self._advance(hw0, seed.get("init_rounds", 0), rounds)
                # Fresh: n per fresh column position; cached: the rounds
                # served from the ring plus n per repaired point.
                swap_evals += 2 * n * k + n * (self.ring.fresh_pos - fresh0)
                carry = (sr.sums, sr.sqsums, rounds, d1, d2, assign)
            else:
                swap_evals += 2 * n * k + n_evals
            swap_cached += n_cached + n * n_chg
            # The JAX sharded fit's accept rule, on the host.
            if not new_loss < loss - 1e-7 * max(1.0, abs(loss)):
                converged = True
                break
            m_idx, x_idx = divmod(best, n)
            old = medoids[m_idx]
            medoids[m_idx] = x_idx
            # The mask moves by the device indices (no scalar copy).
            med_mask.index_fill_(0, med_t[m_idx:m_idx + 1], False)
            med_mask.index_fill_(0, cand[m_idx:m_idx + 1], True)
            med_t = cand
            res.swap_history.append((old, x_idx, new_loss))
            loss = new_loss
        res.evals_by_phase["swap"] = swap_evals
        if self.pic:
            res.evals_by_phase["swap_cached"] = swap_cached
        res.medoids = np.asarray(medoids, np.int64)
        res.loss = loss
        res.converged = converged


class MedoidCurator:
    """Embedding-space curation (the JAX package's LM-stack entry point):
    cluster an embedding table, return medoid indices and assignments.

    The sharded path is taken when ``group`` (or ``mesh=``'s data group,
    :func:`data_group`) has more than one rank; otherwise (no group, or a
    one-rank group) the single-device ``BanditPAM(..., baseline="leader")``
    runs.  Every rank of the group calls :meth:`curate` with the same
    embeddings."""

    def __init__(self, k: int, group=None, metric: str = "cosine",
                 seed: int = 0, backend: str = "auto",
                 device: DeviceLike = None, mesh=None):
        if mesh is not None:
            if group is not None:
                raise ValueError("pass a group or a mesh, not both")
            group = data_group(mesh)
        self.k, self.group, self.metric, self.seed = k, group, metric, seed
        self.backend = backend
        self.device = device

    def curate(self, embeddings) -> Tuple[np.ndarray, np.ndarray]:
        dev = resolve_device(self.device)
        with host_stage("the embeddings"):
            emb = torch.as_tensor(embeddings, dtype=torch.float32).to(
                dev).contiguous()
        if self.group is not None and dist.get_world_size(self.group) > 1:
            fit = DistributedBanditPAM(self.k, self.group, metric=self.metric,
                                       seed=self.seed, backend=self.backend,
                                       device=dev).fit(emb)
        else:
            fit = BanditPAM(self.k, metric=self.metric, seed=self.seed,
                            baseline="leader", backend=self.backend,
                            device=dev).fit(emb)
        metric = resolve_metric(self.metric)
        with host_stage("the medoids"):
            med = torch.as_tensor(fit.medoids).to(dev)
        _, _, assign = medoid_cache(
            emb, med, metric=metric,
            backend=resolve_stats_backend(self.backend, metric, dev))
        return fit.medoids, assign.cpu().numpy()


# ---------------------------------------------------------------------------
# Ranks as processes on this host
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankFit(NamedTuple):
    """One rank's fit: its report and its all-reduces by phase."""
    report: FitReport
    allreduces: Dict[str, int]


def _rank_main(rank, cases, world, init, timeout, device, queue):
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = []
        for data, k, params in cases:
            reset_allreduce_counts()
            rep = DistributedBanditPAM(k, device=device, **params).fit(data)
            out.append(RankFit(rep, allreduce_counts()))
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn_fits(cases, world_size: int, *, device: DeviceLike = None,
               timeout: float = 600.0) -> List[List[RankFit]]:
    """Fit ``DistributedBanditPAM(k, **params).fit(data)`` for each
    ``(data, k, params)`` of ``cases`` on ``world_size`` ranks of a
    ``gloo`` group, each a new process of this host (one set of
    processes for every case; address ``tcp://127.0.0.1:<free port>``,
    collective timeout ``timeout`` s).  ``device=None`` is the card, as
    for every entry point (``core.device``): it raises without one, and
    CPU callers pass ``device="cpu"``.  On the card rank r takes card
    ``r mod device_count``: gloo takes CUDA tensors, so several ranks may
    share one card.  Returns, for each case, every rank's
    :class:`RankFit` in rank order.  A rank that raises, or a run past
    ``timeout`` seconds, stops every rank and raises; every process is
    ended before returning."""
    device = resolve_device(device).type
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(list(cases), world_size, init, timeout, device,
                          queue),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    out: Dict[int, Any] = {}
    try:
        while True:
            while not queue.empty():
                rank, value = queue.get()
                out[rank] = value
            if procs.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks ran past "
                                   f"{timeout} s")
        while not queue.empty():
            rank, value = queue.get()
            out[rank] = value
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [list(fits) for fits in zip(*(out[r] for r in range(world_size)))]
