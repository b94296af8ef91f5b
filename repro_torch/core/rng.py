"""The random-draw seam: where a fit takes its reference permutations.

Permutation sampling (paper Appendix 2.2) gives every adaptive search one
random permutation of the reference set; the fit consumes them in a
fixed order: one per BUILD selection (``build_perm(i)``, i < k), then one
per SWAP iteration (``build_perm`` first, ``swap_perm(t)`` after).

The JAX package draws them from its threefry chain (``PRNGKey(seed)`` →
one subkey per search → ``jax.random.permutation``).  ``torch.Generator``
cannot reproduce those bits, so the same seed gives the two packages
different permutations — and hence, in general, different medoids.  A
layout source decouples the fit loop from where the permutations come
from:

* :func:`from_generator` (the default) draws ``torch.randperm(n)`` from
  one seeded ``torch.Generator`` on the fit's device, in the order the
  fit consumes them;
* :func:`from_numpy` replays given ``[k, n]`` BUILD and ``[T, n]`` SWAP
  permutations — the parity tests fill it from the JAX chain, and then
  both packages walk identical layouts.

A torch replica of threefry, which would make the seeds compatible, is
ROADMAP A12.
"""

from __future__ import annotations

import numpy as np
import torch


class GeneratorLayouts:
    """Permutations drawn from one seeded ``torch.Generator``.  Draws are
    sequential, so the searches must ask in the fit's order."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.drawn = {"build": 0, "swap": 0}

    def _draw(self, phase: str, i: int, n: int) -> torch.Tensor:
        # All BUILD draws come before the first SWAP draw, each in order.
        if i != self.drawn[phase] or (phase == "build" and self.drawn["swap"]):
            raise ValueError(f"layouts must be drawn in fit order; asked "
                             f"for {phase}[{i}] after {self.drawn}")
        self.drawn[phase] += 1
        return torch.randperm(n, generator=self.gen, device=self.device)

    def build_perm(self, i: int, n: int) -> torch.Tensor:
        return self._draw("build", i, n)

    def swap_perm(self, t: int, n: int) -> torch.Tensor:
        return self._draw("swap", t, n)


class ArrayLayouts:
    """Permutations given up front: ``build[k, n]`` and ``swap[T, n]``."""

    def __init__(self, build: np.ndarray, swap: np.ndarray):
        self.build = _check_perms(build, "build")
        self.swap = _check_perms(swap, "swap")

    def build_perm(self, i: int, n: int) -> np.ndarray:
        return _row(self.build, i, n, "build")

    def swap_perm(self, t: int, n: int) -> np.ndarray:
        return _row(self.swap, t, n, "swap")


def _check_perms(p, what: str) -> np.ndarray:
    p = np.asarray(p)
    if p.ndim != 2 or not np.issubdtype(p.dtype, np.integer):
        raise ValueError(f"{what} permutations must be an integer [count, n] "
                         f"array, got {p.dtype} {p.shape}")
    return p.astype(np.int64)


def _row(p: np.ndarray, i: int, n: int, what: str) -> np.ndarray:
    if i >= p.shape[0]:
        raise ValueError(f"the fit asked for {what} permutation {i}; only "
                         f"{p.shape[0]} were given")
    if p.shape[1] != n:
        raise ValueError(f"{what} permutations are over {p.shape[1]} "
                         f"points; the data has {n}")
    return p[i]


def from_generator(seed: int, device) -> GeneratorLayouts:
    return GeneratorLayouts(seed, device)


def from_numpy(build_perms, swap_perms) -> ArrayLayouts:
    return ArrayLayouts(build_perms, swap_perms)


def as_device_perm(perm, device: torch.device) -> torch.Tensor:
    """A drawn permutation as an int64 tensor on ``device``."""
    return torch.as_tensor(perm, dtype=torch.int64).to(device)
