"""Synthetic statistical twins of the paper's datasets (numpy): the
port's own copy of ``repro.core.datasets`` (the same draws in the same
order, so every array is bit-equal to the JAX package's), and
``code_blobs``, integer-valued blobs for parity checks at large k.

* ``mnist_like``     — 784-d, 10-mode mixture, coordinates in [0, 1]; arm
  means are well spread, so BanditPAM's assumptions hold (paper §6).
* ``scrna_like``     — 1000-d sparse non-negative "expression counts"
  (log1p of a zero-inflated gamma-Poisson); fitted with l1 (Fig. 3b).
* ``scrna_pca_like`` — 10-d dense projections whose arm means crowd the
  minimum: the Appendix 1.3 violation regime (scaling near n^1.2).
* ``hoc4_like``      — small-integer vectors standing in for AST
  edit-distance features (tree-edit cost ≈ l1 on node counts, Fig. 1b).

``GENERATORS`` and ``make`` are the JAX module's; ``code_blobs`` is the
port's own and stays out of ``GENERATORS``."""

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


def scrna_like(n: int, seed: int = 0, d: int = 1000, modes: int = 8
               ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base_rate = rng.gamma(0.3, 1.0, size=(modes, d))
    z = rng.integers(0, modes, size=n)
    lam = base_rate[z] * rng.gamma(2.0, 0.5, size=(n, 1))
    counts = rng.poisson(lam).astype(np.float32)
    mask = rng.uniform(size=(n, d)) < 0.85          # zero inflation (dropout)
    counts[mask] = 0.0
    return np.log1p(counts).astype(np.float32)


def scrna_pca_like(n: int, seed: int = 0, d: int = 10) -> np.ndarray:
    """The Appendix 1.3 violation regime: the bulk of the arm means is
    concentrated about the minimum (isotropic low-d Gaussian — shell
    concentration) while a few heavy-tailed outliers inflate every arm's
    reward tails (large sigma_x)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    out = rng.uniform(size=n) < 0.03
    t = np.abs(rng.standard_t(2.0, size=(int(out.sum()), 1))).astype(
        np.float32)
    x[out] *= 1.0 + 3.0 * t
    return x


def hoc4_like(n: int, seed: int = 0, d: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    depth = rng.integers(1, 6, size=n)
    x = rng.poisson(lam=depth[:, None] * rng.uniform(0.2, 1.0, size=(1, d)))
    return x.astype(np.float32)


GENERATORS = {
    "mnist_like": mnist_like,
    "scrna_like": scrna_like,
    "scrna_pca_like": scrna_pca_like,
    "hoc4_like": hoc4_like,
}


def make(name: str, n: int, seed: int = 0, **kw) -> np.ndarray:
    return GENERATORS[name](n, seed=seed, **kw)


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
