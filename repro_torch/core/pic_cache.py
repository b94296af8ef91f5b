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

The port's fit loop runs on the host, so ``hw`` and ``fresh_pos`` are
Python ints and a fresh block is written through in place
(``cols[:, s:s+B].copy_(dxy)``), the counterpart of the JAX package's
buffer donation.  The sharded fit (``core.distributed``) gives each rank
the ring of the columns its own rows produce, ``[n, W·b_loc]``, read and
written through :func:`shard_slot_read_write`.  A batch of fits
(``fit_batch``) gives every lane one ring width,
:func:`resolve_batch_cache_rounds`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["PicCache", "DEFAULT_CACHE_ROUNDS", "resolve_cache_rounds",
           "resolve_batch_cache_rounds", "make_cache",
           "shard_slot_read_write", "cache_read_or_write",
           "cache_advance", "carry_valid", "fresh_positions"]

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


def cache_read_or_write(be, data: torch.Tensor, ref_idx: torch.Tensor, *,
                        metric: str, batch_size: int, rnd: int, b_eff: int,
                        cache: PicCache):
    """One PIC access in a bandit round: round ``rnd``'s ``[n, B]`` block,
    from the ring or fresh through the backend's pairwise path (``b_eff``
    effective positions).  Returns ``(dxy, cache)``; the cache is
    updated in place."""
    dxy = shard_slot_read_write(
        cache.cols, rnd, cache.hw, batch_size,
        lambda: be.pairwise(data, data[ref_idx], metric=metric))
    return dxy, cache_advance(cache, rnd, b_eff, cache.rounds_cap(batch_size))


def carry_valid(cache: PicCache, block: int) -> bool:
    """Whether carried moments may seed the next search: no round has
    been recycled yet, so the permutation prefix is resident and slots
    are the identity map of rounds."""
    return cache.hw <= cache.rounds_cap(block)


def fresh_positions(fresh_pos_before: int, cache: PicCache) -> int:
    """Positions computed fresh since ``fresh_pos_before`` (a column
    each, ``n`` evaluations, multiplied on the host)."""
    return cache.fresh_pos - fresh_pos_before
