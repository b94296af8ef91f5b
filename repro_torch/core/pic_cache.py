"""The BanditPAM++ permutation-invariant column (PIC) cache: a bounded
ring of distance columns with round recycling (counterpart of
``repro.core.pic_cache``).

Every search of a ``reuse="pic"`` fit walks the SAME fixed reference
permutation, so round ``r`` always consumes the same reference slice and
its ``[n, B]`` distance block can be computed once and replayed by every
later search (BanditPAM++, Tiwari et al. 2023).

* **Bounded width**: the ring holds ``W`` round-blocks (``cache_width``
  columns, default ``DEFAULT_CACHE_ROUNDS`` rounds), so it takes
  ``n·W·B`` floats: 768 MB at n = 60,000 by default, and an ``n × n``
  ring (14.4 GB at n = 60,000) at ``cache_width=n``.
* **Round recycling**: round ``r`` lives in slot ``r mod W``.  The
  resident window is the trailing ``[max(hw − W, 0), hw)`` of the ``hw``
  rounds ever written.  A round outside it is computed fresh, and
  written through only when it is a NEW round (``r ≥ hw``): keeping an
  evicted replay would evict a newer round and break the window.
* **Ledger**: ``fresh_pos`` counts the effective (non-padding) reference
  positions of every round computed fresh, first computations and
  evicted replays alike; each costs ``n`` evaluations (a whole column),
  which the fit multiplies on the host in Python ints.

The carried-moment repair reads the permutation prefix of the ring; that
prefix is resident, and slots are the identity map of rounds, exactly
while ``hw ≤ W`` (:func:`carry_valid`).

``hw`` and ``fresh_pos`` are Python ints.  The single fit moves them a
search at a time: a search's rounds run in order from its first, so
within it the window is the one its first round saw, and each round's
access follows from the search's starting ``hw`` alone
(:func:`search_read_or_write`): served from its slot, a NEW round
(``r ≥ hw``) computed by the backend's pairwise path straight into its
slot, a recycled one into a block of its own.  A round enqueued after its
search stopped (the device-resident loop's masked round) passes a run
flag of 0, so its pairwise launch writes nothing, and the host charges
only the rounds the search ran once it knows their count
(:func:`search_advance`).  The sharded fit (``core.distributed``) gives
each rank the ring of the columns its own rows produce, ``[n, W·b_loc]``,
moved the same way a search at a time by its device-resident loop (the
default); its stepped loop (``fused=False``) reads and writes it a round
at a time through :func:`shard_slot_read_write` (a fresh block copied in
place, the counterpart of the JAX package's buffer donation) and
:func:`cache_advance`.  A batch of fits (``fit_batch``) gives every lane
one ring width, :func:`resolve_batch_cache_rounds`.

The batch's lanes (:class:`LaneRing`, ``fit_batch`` under ``reuse="pic"``)
keep their rings in one ``[L, n_pad, (W+1)·B]`` tensor: lane l's ring is
its first ``W·B`` columns, with the single fit's slots, and its last B
columns are the lane's scratch, where a recycled round's fresh block
goes (never into the ring).  Each lane keeps its own host ``hw`` and
``fresh_pos``.  Every lane's round r uses the same slot ``(r mod W)·B``;
only the choice (served, new or recycled) differs between lanes, and it
follows from each lane's ``hw`` at the search's start, so
:func:`lane_plan` builds the ``[R, L]`` choice table once per search and
:func:`lane_advance` moves every lane's state at its end, each lane
exactly as :func:`search_read_or_write` / :func:`search_advance` move a
single fit's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["PicCache", "DEFAULT_CACHE_ROUNDS", "resolve_cache_rounds",
           "resolve_batch_cache_rounds", "make_cache",
           "shard_slot_read_write", "cache_advance", "carry_valid",
           "search_read_or_write", "search_advance", "LaneRing", "LanePlan",
           "make_lane_ring", "lane_plan", "lane_advance", "to_device"]

# Default ring width in round-blocks: fits up to n = 3,200 at B = 100
# never recycle, and the ring stays O(n·W·B) at large n.
DEFAULT_CACHE_ROUNDS = 32


@dataclasses.dataclass
class PicCache:
    """The ring and its host-side state.

    ``cols`` is ``[n, W·B]`` float32 on the fit's device; ``hw`` the
    rounds ever written (monotone; the resident window is
    ``[max(hw − W, 0), hw)``); ``fresh_pos`` the effective reference
    positions computed fresh so far.
    """

    cols: torch.Tensor
    hw: int = 0
    fresh_pos: int = 0

    def rounds_cap(self, block: int) -> int:
        """The ring's capacity W in round-blocks of ``block`` columns."""
        return self.cols.shape[1] // block


def resolve_cache_rounds(n_rounds_max: int, batch_size: int,
                         cache_width: Optional[int] = None) -> int:
    """The ``cache_width`` knob (columns) as a round-block count.

    ``None`` gives ``min(n_rounds_max, DEFAULT_CACHE_ROUNDS)``; otherwise
    the width is rounded DOWN to whole rounds and clamped to
    ``[1, n_rounds_max]``.  A width under one round-batch raises: such a
    ring could never serve a read.
    """
    if cache_width is None:
        return min(n_rounds_max, DEFAULT_CACHE_ROUNDS)
    cache_width = int(cache_width)
    if cache_width < batch_size:
        raise ValueError(
            f"cache_width={cache_width} is narrower than one round-batch "
            f"(batch_size={batch_size}); need cache_width >= batch_size")
    return max(1, min(n_rounds_max, cache_width // batch_size))


def resolve_batch_cache_rounds(ns, batch_size: int,
                               cache_width: Optional[int] = None) -> int:
    """One ring width for a batch of fits (``fit_batch``): the maximum of
    each fit's own width, so every lane has at least the ring it would
    have alone (a fit that does not recycle alone does not recycle in the
    batch); a lane with a smaller n leaves its trailing slots cold."""
    return max(resolve_cache_rounds(-(-int(n) // batch_size), batch_size,
                                    cache_width) for n in ns)


def make_cache(n_rows: int, block: int, rounds: int,
               device) -> PicCache:
    """An all-cold ring of ``rounds`` slots of ``block`` columns."""
    return PicCache(cols=torch.zeros((n_rows, rounds * block),
                                     dtype=torch.float32, device=device))


def _in_window(rnd: int, hw: int, rounds_cap: int) -> bool:
    return max(hw - rounds_cap, 0) <= rnd < hw


def shard_slot_read_write(cols: torch.Tensor, rnd: int, hw: int, block: int,
                          compute_fresh: Callable[[], torch.Tensor]
                          ) -> torch.Tensor:
    """One ring access: round ``rnd``'s block from its slot when resident,
    else ``compute_fresh() -> [rows, block]``, written into its slot in
    place when ``rnd ≥ hw``.  The caller advances ``hw``."""
    W = cols.shape[1] // block
    slot = (rnd % W) * block
    if _in_window(rnd, hw, W):
        return cols[:, slot:slot + block]
    dxy = compute_fresh()
    if rnd >= hw:
        cols[:, slot:slot + block].copy_(dxy)
    return dxy


def cache_advance(cache: PicCache, rnd: int, b_eff: int,
                  rounds_cap: int) -> PicCache:
    """After an access to round ``rnd``: charge ``b_eff`` fresh positions
    unless it was served from the window, and move ``hw`` past it."""
    if not _in_window(rnd, cache.hw, rounds_cap):
        cache.fresh_pos += int(b_eff)
    cache.hw = max(cache.hw, rnd + 1)
    return cache


def search_read_or_write(be, data: torch.Tensor, ref_idx: torch.Tensor, *,
                         metric: str, batch_size: int, rnd: int, hw0: int,
                         cache: PicCache,
                         run: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round ``rnd``'s ``[n, B]`` block in a search that started at
    high-water mark ``hw0``: from its slot when in the window
    ``[max(hw0 − W, 0), hw0)``; a NEW round (``rnd ≥ hw0``) computed by
    the backend's pairwise path straight into its slot ``cols[:, s:s+B]``;
    a recycled one (``rnd < hw0 − W``) into a block of its own, not
    written through (that would evict a newer round).  ``run`` is the
    round's flag (None: it runs): at 0 the slot keeps its bytes.  The
    state moves with :func:`search_advance` at the search's end."""
    W = cache.rounds_cap(batch_size)
    s = (rnd % W) * batch_size
    slot = cache.cols[:, s:s + batch_size]
    if _in_window(rnd, hw0, W):
        return slot
    y = data.index_select(0, ref_idx)
    if rnd >= hw0:
        return be.pairwise(data, y, metric=metric, out=slot, run=run)
    return be.pairwise(data, y, metric=metric, run=run)


def _advance(hw: int, fresh_pos: int, hw0: int, r0: int, r_end: int,
             sizes, rounds_cap: int):
    """``(hw, fresh_pos)`` after a search from ``hw0`` ran rounds
    ``[r0, r_end)``: each round outside the window charged its effective
    positions ``sizes[r]``, ``hw`` moved past the last one."""
    fresh_pos += sum(sizes[r] for r in range(r0, r_end)
                     if not _in_window(r, hw0, rounds_cap))
    if r_end > r0:
        hw = max(hw0, r_end)
    return hw, fresh_pos


def search_advance(cache: PicCache, hw0: int, r0: int, r_end: int, sizes,
                   block: int) -> PicCache:
    """After a search from high-water mark ``hw0`` ran rounds
    ``[r0, r_end)``: charge the effective positions ``sizes[r]`` of each
    round outside the window (first computations and recycled rounds
    alike) and move ``hw`` past the last one.  The same state as
    :func:`cache_advance` after each of those rounds in turn."""
    cache.hw, cache.fresh_pos = _advance(cache.hw, cache.fresh_pos, hw0, r0,
                                         r_end, sizes,
                                         cache.rounds_cap(block))
    return cache


def carry_valid(cache: PicCache, block: int) -> bool:
    """Whether carried moments may seed the next search: no round has
    been recycled yet, so the permutation prefix is resident and slots
    are the identity map of rounds."""
    return cache.hw <= cache.rounds_cap(block)


# ---------------------------------------------------------------------------
# The batch's lane rings (fit_batch under reuse="pic")
# ---------------------------------------------------------------------------

def to_device(values, dtype, device) -> torch.Tensor:
    """A host table on ``device`` without waiting for the device: on a
    card through pinned memory and an asynchronous copy (a pageable copy
    would wait for the stream's queued work)."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class LaneRing:
    """L rings of ``W`` round-blocks of ``block`` columns and their host
    state (see the module docstring).

    ``store`` is ``[L, n_pad, (W+1)·block]`` float32 on the batch's
    device: lane l's ring is ``store[l, :n_l, :W·block]``, its scratch
    ``store[l, :n_l, W·block:]``; ``hw[l]`` and ``fresh_pos[l]`` are lane
    l's :class:`PicCache` fields.
    """

    store: torch.Tensor
    block: int
    hw: list
    fresh_pos: list

    @property
    def rounds_cap(self) -> int:
        return self.store.shape[2] // self.block - 1

    @property
    def scratch(self) -> int:
        """The scratch's first column."""
        return self.rounds_cap * self.block

    @property
    def rings(self) -> torch.Tensor:
        """Every lane's ring, ``[L, n_pad, W·block]`` (a view)."""
        return self.store[:, :, :self.scratch]

    def carry_valid(self, lane: int) -> bool:
        """:func:`carry_valid` for lane ``lane``."""
        return self.hw[lane] <= self.rounds_cap


def make_lane_ring(lanes: int, n_pad: int, block: int, rounds: int,
                   device) -> LaneRing:
    """``lanes`` all-cold rings of ``rounds`` slots of ``block`` columns."""
    store = torch.zeros((lanes, n_pad, (rounds + 1) * block),
                        dtype=torch.float32, device=device)
    return LaneRing(store=store, block=block, hw=[0] * lanes,
                    fresh_pos=[0] * lanes)


class LanePlan(NamedTuple):
    """One search's ring accesses, lane by lane (:func:`lane_plan`).

    ``col[r][l]`` (host) and ``col_dev`` ``[R, L]`` int64: the first
    column of lane l's round-r block in the ring's store (its slot, or the
    scratch for a recycled round); ``fresh_dev`` ``[R, L]`` int32: 1 where
    the round computes its block (a new or a recycled round), the run
    flag of the lane ``pairwise`` launch; ``any_fresh[r]`` whether some
    lane computes round r; ``free`` ``[L, R]`` bool: the rounds served
    from the window, charged to the cached ledger; ``hw0`` the lanes'
    starting ``hw``."""
    col: list
    col_dev: torch.Tensor
    fresh_dev: torch.Tensor
    any_fresh: list
    free: torch.Tensor
    hw0: list


def lane_plan(ring: LaneRing, budgets, n_rounds: int) -> LanePlan:
    """The ``[R, L]`` choice table of a search that starts now, each
    lane's round r as :func:`search_read_or_write` would access it from
    the lane's ``hw``: served from its slot in the window, NEW (``r ≥
    hw``) computed into its slot, recycled computed into the scratch.
    ``budgets[l]`` is lane l's round budget (its rounds past it are
    masked and access nothing); ``n_rounds`` the table's R."""
    B, W = ring.block, ring.rounds_cap
    r = np.arange(n_rounds)[:, None]                              # [R, 1]
    hw0 = np.asarray(ring.hw)[None, :]                            # [1, L]
    ran = r < np.asarray(budgets)[None, :]
    served = ran & (r >= np.maximum(hw0 - W, 0)) & (r < hw0)     # window
    fresh = ran & ~served
    col = np.where(fresh & (r < hw0), ring.scratch, (r % W) * B)
    free = served.T
    dev = ring.store.device
    return LanePlan(col=col.tolist(), col_dev=to_device(col, torch.int64, dev),
                    fresh_dev=to_device(fresh, torch.int32, dev),
                    any_fresh=fresh.any(axis=1).tolist(),
                    free=to_device(free, torch.bool, dev),
                    hw0=list(ring.hw))


def lane_advance(ring: LaneRing, plan: LanePlan, lanes, r0s, r_ends,
                 sizes) -> LaneRing:
    """After a search planned by ``plan``: lane l (of ``lanes``) ran rounds
    ``[r0s[l], r_ends[l])``; each lane's state moves as
    :func:`search_advance` moves a single fit's (``sizes[l]`` its
    rounds' effective positions)."""
    for l in lanes:
        ring.hw[l], ring.fresh_pos[l] = _advance(
            ring.hw[l], ring.fresh_pos[l], plan.hw0[l], r0s[l], r_ends[l],
            sizes[l], ring.rounds_cap)
    return ring
