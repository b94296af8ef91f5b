"""The plain reference of a BanditPAM fit: BUILD and SWAP, each driven by
Algorithm 1's adaptive search under permutation sampling, written from
the paper (Tiwari et al., NeurIPS 2020, Eqs. 6, 7, 11, 12 and App. 2.2)
and BanditPAM++'s fixed-permutation column reuse (Tiwari et al., 2023),
in plain PyTorch, by default in float64.  It imports nothing of the
program and takes nothing the program made: it draws the reference
permutations itself from the fit seed (``threefry``, a frozen copy of
the draw source), computes every distance itself, and counts the
evaluation ledger itself.

What the program's fit is held to, search by search:

* BUILD search i (arms: the points not yet chosen) uses the i-th
  permutation of the fit seed's chain (``reuse="pic"``: the chain's
  fixed permutation in every search), tiled into rounds of B reference
  points; round r adds each arm's Σg and Σg², g = min(d(x, y) −
  d_near(y), 0) (d(x, y) while no medoid is chosen); σ comes from the
  search's first batch plus 1e-8; an arm dies when its lower bound
  exceeds the least upper bound, the bounds ±σ·sqrt(log(1/δ)/n_used)
  ·sqrt(1 − n_used/n), δ = 1/(1000·n); the search ends with one arm left
  or every reference used, and picks the first arm of least mean.  Each
  round costs (active arms) × (reference points) evaluations.
* SWAP search t (arms: (medoid slot m, point x), δ = 1/(1000·k·n)) uses
  the FastPAM1 form g = −d1(y) + min(d2(y) if y is in m's cluster else
  d1(y), d(x, y)); a round costs (points with an active arm) × B.  The
  swap is taken when the loss falls by more than 1e-7 of it; at most
  4k + 10 iterations.  The ledger adds n·k for BUILD and 2·n·k for every
  SWAP iteration.
* Under column reuse a round inside the ring's window of the last W
  rounds ever computed is served (cached evaluations, at the same
  count), every other round is a fresh column block (n evaluations a
  reference point), and while no round was recycled a SWAP search
  resumes at the last search's round with its moments carried (here:
  recomputed over that prefix under the new medoids); the repair counts
  n cached evaluations a reference point of the prefix whose nearest,
  second-nearest or assignment changed.

:func:`walk` runs a fit.  With ``follow`` (the program's decisions,
:func:`decisions`) it takes the program's pick after each of its own
searches, so a pick that differs at a float32 margin does not carry into
the next search, and it records how far each of the program's decisions
lies from its own in exact loss.  Without ``follow`` it walks its own
trajectory: put in the program's place in a lower precision
(``precision="tf32"``), it is the comparison's control.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .threefry import Draws

SIGMA_FLOOR = 1e-8
ACCEPT_REL = 1e-7


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even): what a tensor core reads of a float32 operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Space:
    """The points and their dissimilarity in one precision:
    ``"float64"`` (the reference), ``"float32"`` (the Gram form for l2,
    TF32 off) or ``"tf32"`` (the control, arithmetic in float32: l2 as
    ``torch.cdist`` takes it under TF32, the norms in float32 and the
    cross term a matmul of operands rounded to TF32; l1 over operands
    rounded to TF32)."""

    def __init__(self, x: np.ndarray, metric: str, precision: str, device):
        if metric not in ("l1", "l2"):
            raise ValueError(f"the reference has no metric {metric!r}")
        t = torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(device)
        if precision == "float64":
            self.x = t.to(torch.float64)
        elif precision == "float32":
            self.x = t
        elif precision == "tf32":
            self.x = t if metric == "l2" else round_tf32(t)
            self.xr = round_tf32(t)
            self.xx = torch.sum(t * t, dim=1)
        else:
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = self.x.dtype
        self.precision = precision
        self.metric = metric
        self.n = self.x.shape[0]
        self.device = self.x.device

    def dist(self, rows: Optional[torch.Tensor], cols: torch.Tensor
             ) -> torch.Tensor:
        """``[len(rows), len(cols)]`` dissimilarities (rows None: all)."""
        a = self.x if rows is None else self.x.index_select(0, rows)
        b = self.x.index_select(0, cols)
        if self.metric == "l1":
            return torch.cdist(a, b, p=1.0)
        if self.precision != "tf32":
            # The Gram form, exact to ~1e-16 of the norms in float64.
            return torch.cdist(a, b, p=2.0,
                               compute_mode="use_mm_for_euclid_dist")
        xr = self.xr if rows is None else self.xr.index_select(0, rows)
        xx = self.xx if rows is None else self.xx.index_select(0, rows)
        dot = xr @ self.xr.index_select(0, cols).T
        return torch.sqrt(torch.clamp_min(
            xx[:, None] + self.xx.index_select(0, cols)[None, :] - 2.0 * dot,
            0.0))

    def to_medoids(self, meds: Sequence[int]) -> torch.Tensor:
        """``[n, k]`` distances of every point to the medoids."""
        return self.dist(None, torch.as_tensor(list(meds), dtype=torch.int64,
                                               device=self.device))

    def loss(self, meds: Sequence[int]) -> float:
        return float(torch.min(self.to_medoids(meds), dim=1).values.sum())

    def top2(self, meds: Sequence[int]):
        """(d1, d2, assign): nearest and second-nearest medoid distance and
        the nearest medoid's slot (the first on ties)."""
        dm = self.to_medoids(meds)
        vals, _ = torch.sort(dm, dim=1)
        d2 = (vals[:, 1] if dm.shape[1] > 1
              else torch.full_like(vals[:, 0], float("inf")))
        return vals[:, 0], d2, torch.argmin(dm, dim=1)


class Search(NamedTuple):
    best: int                 # flat arm index (slot·n + point)
    r0: int                   # the round it started at
    rounds: int               # the round after its last (absolute)
    costs: List[int]          # evaluations of each round it ran


def _tiling(perm: torch.Tensor, n: int, B: int) -> torch.Tensor:
    R = -(-n // B)
    reps = -(-R * B // n)
    return perm.repeat(reps)[:R * B]


def _search(space: Space, stats, active: torch.Tensor, slots_cost: bool,
            perm: torch.Tensor, B: int, delta: float, r0: int = 0,
            init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Search:
    """Algorithm 1 over the arms ``active`` ([slots, n] bool) with
    ``stats(refs, cand) -> (Σg, Σg²)`` of shape [slots, len(cand)] for
    the candidate points ``cand``.  A round costs the active arms
    (``slots_cost`` False) or the points with an active arm (True) times
    its reference points."""
    n = space.n
    dt = space.dtype
    tiled = _tiling(perm, n, B)
    sizes = [min(B, n - r * B) for r in range(-(-n // B))]
    log_term = math.log(1.0 / delta)
    active = active.clone()
    slots = active.shape[0]
    if init is None:
        sums = torch.zeros((slots, n), dtype=dt, device=space.device)
        sq = torch.zeros_like(sums)
        sigma = None
    else:
        sums, sq = init
        n0 = max(sum(sizes[:r0]), 1)
        mu0 = sums / n0
        sigma = torch.sqrt(torch.clamp_min(sq / n0 - mu0 * mu0, 0.0)) \
            + SIGMA_FLOOR
    n_used = sum(sizes[:r0])
    r = r0
    costs = []
    while n_used < n and int(active.sum()) > 1:
        b = sizes[r]
        refs = tiled[r * B:r * B + b]
        live = torch.any(active, dim=0)
        cand = torch.nonzero(live).reshape(-1)
        s_b, q_b = stats(refs, cand)
        sums[:, cand] += s_b
        sq[:, cand] += q_b
        n_new = n_used + b
        if n_used == 0:
            mean_b = s_b / b
            sig = torch.full_like(sums, float("inf"))
            sig[:, cand] = torch.sqrt(torch.clamp_min(
                q_b / b - mean_b * mean_b, 0.0)) + SIGMA_FLOOR
            sigma = sig
        mu = sums / n_new
        ci = sigma * (math.sqrt(log_term / n_new)
                      * math.sqrt(max(1.0 - n_new / n, 0.0)))
        ucb = torch.where(active, mu + ci, torch.full_like(mu, math.inf))
        kill = active & (mu - ci > torch.min(ucb))
        costs.append((int(live.sum()) if slots_cost else int(active.sum()))
                     * b)
        active &= ~kill
        n_used = n_new
        r += 1
    mean = sums / max(n_used, 1)
    pick = torch.where(active, mean, torch.full_like(mean, math.inf))
    return Search(int(torch.argmin(pick.reshape(-1))), r0, r, costs)


def _build_stats(space: Space, dnear: Optional[torch.Tensor]):
    def stats(refs, cand):
        d = space.dist(cand, refs)
        g = d if dnear is None else torch.clamp_max(d - dnear[refs], 0.0)
        return g.sum(1)[None, :], (g * g).sum(1)[None, :]
    return stats


def _swap_stats(space: Space, d1, d2, assign, k: int):
    def stats(refs, cand):
        d = space.dist(cand, refs)
        d1r, d2r = d1[refs][None, :], d2[refs][None, :]
        t1 = torch.minimum(d1r, d) - d1r
        t2 = torch.minimum(d2r, d) - d1r
        onehot = torch.nn.functional.one_hot(assign[refs], k).to(d.dtype)
        s = t1.sum(1)[None, :] + ((t2 - t1) @ onehot).T
        q = (t1 * t1).sum(1)[None, :] + ((t2 * t2 - t1 * t1) @ onehot).T
        return s, q
    return stats


class Decisions(NamedTuple):
    """What the program decided, read from its report: the BUILD picks in
    order, each accepted swap as (slot, point, the loss it reported), and
    whether it stopped on a refused swap (True) or at the iteration
    cap."""
    build: List[int]
    swaps: List[Tuple[int, int, float]]
    converged: bool


def decisions(medoids, history, converged: bool) -> Optional[Decisions]:
    """The program's decisions from its final medoids and swap history
    (``(old point, new point, loss)`` a swap), or None where they do not
    fit together."""
    meds = [int(m) for m in medoids]
    try:
        for old, new, _ in reversed(history):
            meds[meds.index(int(new))] = int(old)
        cur, swaps = list(meds), []
        for old, new, loss in history:
            m = cur.index(int(old))
            swaps.append((m, int(new), float(loss)))
            cur[m] = int(new)
    except ValueError:
        return None
    if len(set(meds)) != len(meds):
        return None
    return Decisions(meds, swaps, bool(converged))


class Walk(NamedTuple):
    medoids: List[int]
    loss: float                          # in the walk's precision
    history: List[Tuple[int, int, float]]
    build_rounds: List[int]
    evals_by_phase: dict
    converged: bool
    gaps: List[float]                    # the program's decisions' excess


class _Ring:
    """The column-reuse window: ``hw`` rounds ever computed, the last
    ``W`` of them resident; ``fresh_pos`` reference points computed
    fresh."""

    def __init__(self, W: int):
        self.W, self.hw, self.fresh_pos = W, 0, 0

    def served(self, r: int, hw0: int) -> bool:
        return max(hw0 - self.W, 0) <= r < hw0

    def advance(self, s: Search, hw0: int, sizes) -> int:
        """Charge a search's rounds; return its cached evaluations."""
        cached = 0
        for r, c in zip(range(s.r0, s.rounds), s.costs):
            if self.served(r, hw0):
                cached += c
            else:
                self.fresh_pos += sizes[r]
        if s.rounds > s.r0:
            self.hw = max(hw0, s.rounds)
        return cached


def walk(space: Space, k: int, seed: int, *, batch_size: int = 100,
         reuse: str = "none", cache_rounds: int = 32,
         follow: Optional[Decisions] = None,
         exact: Optional[Space] = None) -> Walk:
    """One fit (see the module docstring).  ``exact`` (default ``space``)
    computes everything but the searches' statistics: the nearest and
    second-nearest medoids, the losses and the swap's acceptance.  With
    ``follow`` every search
    continues from the program's decision and ``gaps`` holds, a decision
    each, the program's exact loss over the loss of the reference's own
    choice, less one (0 where they agree); a refused last swap adds the
    share of the loss the reference's swap would have saved, an accepted
    one the share by which it raised the loss."""
    n, B = space.n, int(batch_size)
    ex = space if exact is None else exact
    dev = space.device
    draws = Draws(seed, k, dev)
    pic = reuse == "pic"
    fixed = draws.fixed(n) if pic else None
    sizes = [min(B, n - r * B) for r in range(-(-n // B))]
    ring = _Ring(min(len(sizes), cache_rounds)) if pic else None
    evals = {"build": n * k}
    if pic:
        evals["build_cached"] = 0
    gaps: List[float] = []

    # ---- BUILD ----
    meds: List[int] = []
    rounds: List[int] = []
    dnear = None
    taken = torch.zeros((1, n), dtype=torch.bool, device=dev)
    for i in range(k):
        perm = fixed if pic else draws.perm("build", i, n)
        hw0 = ring.hw if pic else 0
        s = _search(space, _build_stats(space, dnear), ~taken, False, perm,
                    B, 1.0 / (1000.0 * n))
        rounds.append(s.rounds)
        if pic:
            evals["build_cached"] += ring.advance(s, hw0, sizes)
        else:
            evals["build"] += sum(s.costs)
        pick = s.best
        if follow is not None:
            pick = follow.build[i]
            if pick != s.best:
                gaps.append(_build_excess(ex, dnear, pick, s.best))
        meds.append(pick)
        taken[0, pick] = True
        col = ex.dist(None, torch.tensor([pick], device=dev))[:, 0]
        dnear = col if dnear is None else torch.minimum(dnear, col)
    if pic:
        evals["build"] += n * ring.fresh_pos

    # ---- SWAP ----
    evals["swap"] = 0
    if pic:
        evals["swap_cached"] = 0
    loss = float(torch.min(ex.to_medoids(meds), dim=1).values.sum())
    history: List[Tuple[int, int, float]] = []
    converged = False
    carry = None            # (rounds, d1, d2, assign) of the last search
    t_max = 4 * k + 10
    if follow is not None:
        t_max = len(follow.swaps) + (1 if follow.converged else 0)
    for t in range(t_max):
        d1, d2, assign = ex.top2(meds)
        stats = _swap_stats(space, d1, d2, assign, k)
        perm = fixed if pic else draws.perm("swap", t, n)
        r0, init, changed = 0, None, 0
        if pic and carry is not None and ring.hw <= ring.W:
            r0 = carry[0]
            prefix = _tiling(perm, n, B)[:min(sum(sizes[:r0]), n)]
            init = stats(prefix, torch.arange(n, device=dev))
            moved = ((carry[1][prefix] != d1[prefix])
                     | (carry[2][prefix] != d2[prefix])
                     | (carry[3][prefix] != assign[prefix]))
            changed = int(moved.sum())
        taken_k = taken.expand(k, n)
        hw0 = ring.hw if pic else 0
        s = _search(space, stats, ~taken_k, True, perm, B,
                    1.0 / (1000.0 * k * n), r0=r0, init=init)
        evals["swap"] += 2 * n * k
        if pic:
            fresh0 = ring.fresh_pos
            evals["swap_cached"] += (ring.advance(s, hw0, sizes)
                                     + n * changed)
            evals["swap"] += n * (ring.fresh_pos - fresh0)
            carry = (s.rounds, d1, d2, assign)
        else:
            evals["swap"] += sum(s.costs)
        m_r, x_r = divmod(s.best, n)
        cand = list(meds)
        cand[m_r] = x_r
        if follow is None:
            new_loss = float(torch.min(ex.to_medoids(cand),
                                       dim=1).values.sum())
            if not new_loss < loss - ACCEPT_REL * max(abs(loss), 1.0):
                converged = True
                break
            m, x = m_r, x_r
        else:
            cur_loss = ex.loss(meds)
            if t == len(follow.swaps):
                # The program refused this iteration's swap.
                ref_loss = ex.loss(cand)
                gaps.append(max(0.0, (cur_loss - ref_loss) / cur_loss))
                converged = True
                break
            m, x, _ = follow.swaps[t]
            if (m, x) != (m_r, x_r):
                gaps.append((ex.loss(_swapped(meds, m, x))
                             - ex.loss(cand)) / ex.loss(cand))
            new_loss = ex.loss(_swapped(meds, m, x))
            gaps.append(max(0.0, (new_loss - cur_loss) / cur_loss))
        history.append((meds[m], x, new_loss))
        taken[0, meds[m]] = False
        taken[0, x] = True
        meds[m] = x
        loss = new_loss
    return Walk(meds, loss, history, rounds, evals, converged, gaps)


def _swapped(meds, m: int, x: int) -> List[int]:
    out = list(meds)
    out[m] = x
    return out


def _build_excess(space: Space, dnear, p: int, r: int) -> float:
    """The loss with point ``p`` added over the loss with ``r`` added,
    less one."""
    cols = space.dist(None, torch.tensor([p, r], device=space.device))
    if dnear is not None:
        cols = torch.minimum(cols, dnear[:, None])
    lp, lr = (float(v) for v in cols.sum(0))
    return (lp - lr) / lr
