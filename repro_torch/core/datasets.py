"""Synthetic MNIST-like data (numpy), the port's own copy of
``repro.core.datasets.mnist_like``: same generator, same bits."""

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
