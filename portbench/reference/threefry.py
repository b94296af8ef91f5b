"""A frozen copy of the draw source the port replays: threefry2x32 and
``jax.random``'s ``PRNGKey``, ``split`` and ``permutation`` (the
partitionable path, 64-bit types off), from
``repro_torch/core/threefry.py``.

The reference imports nothing of the port, so it carries the part of
the draws it needs: with the same fit seed it walks the same reference
permutations as the program, and its searches can be compared with the
program's search by search.  Keys are pairs of host ints; bits are
int64 tensors that hold uint32 values.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pair (x1, x2) under the
    key (k1, k2); ints or int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    return (0, int(seed) & MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    k1, k2 = key
    return [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(num)]


def _bits(k1: int, k2: int, size: int, device) -> torch.Tensor:
    idx = torch.arange(size, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: rounds of a stable sort by
    fresh 32-bit keys."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(_bits(sub[0], sub[1], n, device),
                           stable=True).indices
        x = x.index_select(0, order)
    return x


class Draws:
    """A fit's permutations for ``seed``: ``PRNGKey(seed)`` splits into
    the chain and ``ckey`` (the fixed permutation of a cached fit); search
    ``s`` (BUILD i is s = i, SWAP t is s = k + t) takes the s-th subkey of
    the chain, and its permutation is drawn from ``split(sub)[1]``."""

    def __init__(self, seed: int, k: int, device):
        self.k, self.device = int(k), device
        self._key, self.ckey = split(PRNGKey(seed))
        self._subs: List[Key] = []

    def perm(self, phase: str, i: int, n: int) -> torch.Tensor:
        s = i if phase == "build" else self.k + i
        while len(self._subs) <= s:
            self._key, sub = split(self._key)
            self._subs.append(sub)
        return permutation(split(self._subs[s])[1], n, self.device)

    def fixed(self, n: int) -> torch.Tensor:
        return permutation(self.ckey, n, self.device)
