"""Synthetic data (numpy): the port's own copy of
``repro.core.datasets.mnist_like`` (same generator, same bits), and
``code_blobs``, integer-valued blobs for parity checks at large k."""

from __future__ import annotations

import numpy as np


def mnist_like(n: int, seed: int = 0, d: int = 784, modes: int = 10,
               zdim: int = 10) -> np.ndarray:
    """Low-dim cluster manifold embedded in 784-d + noise floor.

    Matches the paper's MNIST regime: arm means (mean L2 distance to the
    dataset) spread over ~3x the per-arm sigma, with unequal cluster
    sizes providing a dense core and sparse outskirts.
    """
    rng = np.random.default_rng(seed)
    zc = rng.standard_normal((modes, zdim)) * 4.0          # spread-out centers
    w = rng.dirichlet(np.ones(modes) * 0.5)                # unequal cluster sizes
    z = zc[rng.choice(modes, size=n, p=w)] + rng.standard_normal((n, zdim))
    q, _ = np.linalg.qr(rng.standard_normal((d, zdim)))
    x = z @ q.T + 0.05 * rng.standard_normal((n, d))       # high-d noise floor
    return (x / np.abs(x).max()).astype(np.float32)


def code_blobs(n: int, n_blobs: int, d: int = 8, seed: int = 0) -> np.ndarray:
    """``n`` integer points in ``n_blobs`` blobs of (nearly) equal size.

    The centers are 24·c for distinct even-weight c in {0, 1}^d (at
    least 48 apart in l1, 24·sqrt(2) in l2; ``n_blobs`` <= 2^(d-1)); each
    point is its center plus U{-1, 0, 1}^d.  Every l2sq distance is an
    integer, so two implementations that sum its terms in different
    orders agree exactly on it and on its square root: parity checks at
    k in the tens or hundreds, where some of the many kill decisions on
    real-valued data would sit on a float32 margin, stay exact.
    """
    rng = np.random.default_rng(seed)
    codes = np.array([[(v >> b) & 1 for b in range(d)] for v in range(2 ** d)
                      if bin(v).count("1") % 2 == 0])
    centers = 24 * codes[rng.permutation(len(codes))[:n_blobs]]
    labels = rng.permutation(np.arange(n) % n_blobs)
    pts = centers[labels] + rng.integers(-1, 2, size=(n, d))
    return pts.astype(np.float32)
