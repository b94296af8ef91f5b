"""The random-draw seam: where a fit takes its reference batches.

Every adaptive search draws its reference batches from a layout source,
in a fixed order: the k BUILD searches first (``i < k``), then one SWAP
search per iteration (``t``).  Two sampling modes draw differently:

* permutation sampling (paper Appendix 2.2, the default) gives each
  search one random permutation of the reference set
  (``build_perm(i, n)`` / ``swap_perm(t, n)``), which the search tiles
  into consecutive batches;
* replacement sampling (the paper's §3.2) draws each round's batch
  i.i.d. uniform over ``[0, n)`` (``build_draw(i, rnd, n, B)`` /
  ``swap_draw(t, rnd, n, B)``), round by round.  A search runs at most
  ``R = ceil(n/B)`` rounds, since every round consumes B of its n-point
  budget.

A fit with a distance cache (``reuse="pic"``, or ``cache_cols > 0`` under
permutation sampling) instead walks ONE fixed reference permutation in
every search (``fixed_perm(n)``), drawn first, before any BUILD search;
its searches draw nothing of their own.  In the JAX package it is
``jax.random.permutation(ckey, n)``, ``ckey`` being the chain's first
split (``_batch_rng_chains``' first output).

The JAX package draws from its threefry chain: ``PRNGKey(seed)``, then
``key, ckey = split(key)`` (``ckey`` seeds the fixed permutation), then
one subkey per search from successive ``key, sub = split(key)`` (the k
BUILD searches, then the SWAP searches); a search's permutation is
``jax.random.permutation(split(sub)[1], n)``, and in replacement mode it
draws round by round ``key, sub = split(key); randint(sub, (B,), 0, n)``
from its own subkey.  A layout source decouples the fit loop from where
the draws come from:

* :func:`from_seed` (the default) replays that chain with the port's
  threefry (``repro_torch.core.threefry``), so the same seed gives the
  JAX package's draws, and hence its medoids, with no JAX at hand.
  Every search owns its key, so the searches may ask in any order, and a
  replacement search computes all of its rounds' batches at its first
  request;
* :func:`from_numpy` replays given ``[k, n]`` BUILD and ``[T, n]`` SWAP
  permutations and/or ``[k, R, B]`` BUILD and ``[T, R, B]`` SWAP draws
  and/or the ``[n]`` fixed permutation, e.g. draws a test chose itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import threefry


class SeedLayouts:
    """The JAX package's threefry chain for ``seed``: search ``s`` (BUILD
    ``i`` is ``s = i``, SWAP ``t`` is ``s = k + t``) takes the ``s``-th
    subkey of the chain.  ``k`` is the number of BUILD searches before
    the first SWAP search: a fit's k, or 0 for a warm-started fit, which
    skips BUILD and splits its SWAP subkeys from the chain's head (the
    fixed permutation still comes from ``ckey``).  Keys are host ints, so
    drawing reads nothing from the device; the permutations and batches
    are computed on ``device``.  Any order of requests gives the same
    draws."""

    def __init__(self, seed: int, device: torch.device, k: int):
        self.device = torch.device(device)
        self.k = int(k)
        key = threefry.PRNGKey(seed)
        self._key, self.ckey = threefry.split(key)
        self._subs = []             # the chain's search subkeys so far
        self._rounds = None         # (phase, search, n, b) and its batches

    def search_key(self, phase: str, i: int) -> threefry.Key:
        """The subkey of BUILD search ``i`` or SWAP search ``i``."""
        if phase == "build" and i >= self.k:
            raise ValueError(f"this chain has {self.k} BUILD searches; "
                             f"asked for BUILD search {i}")
        s = i if phase == "build" else self.k + i
        while len(self._subs) <= s:
            self._key, sub = threefry.split(self._key)
            self._subs.append(sub)
        return self._subs[s]

    def perm_key(self, phase: str, i: int) -> threefry.Key:
        """The key of search ``i``'s permutation: ``split(sub)[1]``."""
        return threefry.split(self.search_key(phase, i))[1]

    def perm_on(self, phase: str, i: int, n: int,
                device: torch.device) -> torch.Tensor:
        """``{phase}_perm(i, n)`` computed on ``device``."""
        return threefry.permutation(self.perm_key(phase, i), n, device)

    def fixed_perm(self, n: int) -> torch.Tensor:
        return threefry.permutation(self.ckey, n, self.device)

    def build_perm(self, i: int, n: int) -> torch.Tensor:
        return self.perm_on("build", i, n, self.device)

    def swap_perm(self, t: int, n: int) -> torch.Tensor:
        return self.perm_on("swap", t, n, self.device)

    def _draw(self, phase: str, i: int, rnd: int, n: int,
              b: int) -> torch.Tensor:
        # All R = ceil(n/b) rounds of the search at its first request:
        # round r is randint(sub_r, (b,), 0, n) with key, sub_r =
        # split(key) from the search's subkey.
        tag = (phase, i, n, b)
        if self._rounds is None or self._rounds[0] != tag:
            key, subs = self.search_key(phase, i), []
            for _ in range(-(-n // b)):
                key, sub = threefry.split(key)
                subs.append(sub)
            self._rounds = (tag, threefry.randint_rows(subs, b, 0, n,
                                                       self.device))
        rows = self._rounds[1]
        if rnd >= rows.shape[0]:
            raise ValueError(f"the fit asked for {phase}[{i}] round {rnd}; "
                             f"a search runs at most {rows.shape[0]}")
        return rows[rnd]

    def build_draw(self, i: int, rnd: int, n: int, b: int) -> torch.Tensor:
        return self._draw("build", i, rnd, n, b)

    def swap_draw(self, t: int, rnd: int, n: int, b: int) -> torch.Tensor:
        return self._draw("swap", t, rnd, n, b)

    def draw_on(self, phase: str, i: int, rnd: int, n: int, b: int,
                device: torch.device) -> torch.Tensor:
        """``{phase}_draw(i, rnd, n, b)`` on ``device``: a row of the
        search's batches, already there, so no copy and no read."""
        return self._draw(phase, i, rnd, n, b).to(device)


class ArrayLayouts:
    """Draws given up front: permutations ``build[k, n]`` and
    ``swap[T, n]``, and/or replacement draws ``build_draws[k, R, B]`` and
    ``swap_draws[T, R, B]`` with ``R = ceil(n/B)``, and/or the fixed
    permutation ``fixed[n]``."""

    def __init__(self, build: Optional[np.ndarray] = None,
                 swap: Optional[np.ndarray] = None,
                 build_draws: Optional[np.ndarray] = None,
                 swap_draws: Optional[np.ndarray] = None,
                 fixed: Optional[np.ndarray] = None):
        self.build = _check(build, "build permutations", 2)
        self.swap = _check(swap, "swap permutations", 2)
        self.build_draws = _check(build_draws, "build draws", 3)
        self.swap_draws = _check(swap_draws, "swap draws", 3)
        self.fixed = _check(fixed, "the fixed permutation", 1)
        self._uploaded = {}

    def perm_on(self, phase: str, i: int, n: int,
                device: torch.device) -> torch.Tensor:
        """``{phase}_perm(i, n)`` as a row of the phase's permutations on
        ``device``, uploaded whole at the phase's first request: a copy
        from pageable host memory waits for the device, so one copy a
        phase keeps the searches free of hidden syncs."""
        getattr(self, f"{phase}_perm")(i, n)          # validates
        key = (phase, str(device))
        if key not in self._uploaded:
            self._uploaded[key] = as_device_index(getattr(self, phase),
                                                  device)
        return self._uploaded[key][i]

    def fixed_perm(self, n: int) -> np.ndarray:
        if self.fixed is None:
            raise ValueError("no fixed permutation was given (a fit with a "
                             "distance cache needs one)")
        return _perm_row(self.fixed[None, :], 0, n, "fixed")

    def build_perm(self, i: int, n: int) -> np.ndarray:
        return _perm_row(self.build, i, n, "build")

    def swap_perm(self, t: int, n: int) -> np.ndarray:
        return _perm_row(self.swap, t, n, "swap")

    def build_draw(self, i: int, rnd: int, n: int, b: int) -> np.ndarray:
        return _draw_row(self.build_draws, i, rnd, n, b, "build")

    def swap_draw(self, t: int, rnd: int, n: int, b: int) -> np.ndarray:
        return _draw_row(self.swap_draws, t, rnd, n, b, "swap")

    def draw_on(self, phase: str, i: int, rnd: int, n: int, b: int,
                device: torch.device) -> torch.Tensor:
        """``{phase}_draw(i, rnd, n, b)`` as a row of the phase's draws on
        ``device``, uploaded whole at the phase's first request (as
        :meth:`perm_on`)."""
        getattr(self, f"{phase}_draw")(i, rnd, n, b)          # validates
        key = (f"{phase}_draws", str(device))
        if key not in self._uploaded:
            self._uploaded[key] = as_device_index(
                getattr(self, f"{phase}_draws"), device)
        return self._uploaded[key][i, rnd]


def _check(p, what: str, ndim: int) -> Optional[np.ndarray]:
    if p is None:
        return None
    p = np.asarray(p)
    if p.ndim != ndim or not np.issubdtype(p.dtype, np.integer):
        raise ValueError(f"{what} must be an integer {ndim}-d array, got "
                         f"{p.dtype} {p.shape}")
    return p.astype(np.int64)


def _perm_row(p: Optional[np.ndarray], i: int, n: int, what: str
              ) -> np.ndarray:
    if p is None:
        raise ValueError(f"no {what} permutations were given (this source "
                         f"holds replacement draws only)")
    if i >= p.shape[0]:
        raise ValueError(f"the fit asked for {what} permutation {i}; only "
                         f"{p.shape[0]} were given")
    if p.shape[1] != n:
        raise ValueError(f"{what} permutations are over {p.shape[1]} "
                         f"points; the data has {n}")
    return p[i]


def _draw_row(p: Optional[np.ndarray], i: int, rnd: int, n: int, b: int,
              what: str) -> np.ndarray:
    if p is None:
        raise ValueError(f"no {what} replacement draws were given (this "
                         f"source holds permutations only)")
    if i >= p.shape[0]:
        raise ValueError(f"the fit asked for {what} search {i}'s draws; "
                         f"only {p.shape[0]} searches were given")
    if rnd >= p.shape[1]:
        raise ValueError(f"the fit asked for {what}[{i}] round {rnd}; only "
                         f"{p.shape[1]} rounds were given")
    if p.shape[2] != b:
        raise ValueError(f"{what} draws hold batches of {p.shape[2]}; the "
                         f"fit's batch size is {b}")
    row = p[i, rnd]
    if row.min() < 0 or row.max() >= n:
        raise ValueError(f"{what}[{i}] round {rnd} draws lie outside "
                         f"[0, {n})")
    return row


def from_seed(seed: int, device, k: int) -> SeedLayouts:
    """The JAX package's draws for ``seed``; ``k`` is the number of BUILD
    searches that precede the first SWAP search (the fit's k; 0 for a
    warm-started fit)."""
    return SeedLayouts(seed, device, k)


def from_numpy(build_perms=None, swap_perms=None, build_draws=None,
               swap_draws=None, fixed_perm=None) -> ArrayLayouts:
    return ArrayLayouts(build_perms, swap_perms, build_draws, swap_draws,
                        fixed_perm)


def as_device_index(idx, device: torch.device) -> torch.Tensor:
    """A drawn permutation or batch as an int64 tensor on ``device``."""
    return torch.as_tensor(idx, dtype=torch.int64).to(device)
