"""The benchmark's inputs: frozen copies of the port's statistical twins
of the paper's datasets (``repro_torch.core.datasets``), the same numpy
draws in the same order, so each array is bit-equal to the port's for
the same arguments (``tests/test_portbench_data.py`` holds them so).

The copies also return the mixture component of each row, which the
originals draw and drop: ``mnist_like``'s mode and ``scrna_like``'s cell
type ``z``.  A traffic mix may split the rows by it (one clustering per
cell type); the port only ever receives the arrays.

A configuration names its generator in ``"dataset"`` and its rows'
seed in ``"data_seed"``: one dataset a configuration, as the paper
clusters one MNIST; :func:`make` finds the generator in
:data:`GENERATORS`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

Labeled = Tuple[np.ndarray, np.ndarray]


def mnist_like(n: int, seed: int = 0, d: int = 784, modes: int = 10,
               zdim: int = 10) -> Labeled:
    """784-d, 10-mode mixture on a low-dimensional manifold plus a noise
    floor, coordinates in [-1, 1]; returns ``(x, mode)``."""
    rng = np.random.default_rng(seed)
    zc = rng.standard_normal((modes, zdim)) * 4.0
    w = rng.dirichlet(np.ones(modes) * 0.5)
    mode = rng.choice(modes, size=n, p=w)
    z = zc[mode] + rng.standard_normal((n, zdim))
    q, _ = np.linalg.qr(rng.standard_normal((d, zdim)))
    x = z @ q.T + 0.05 * rng.standard_normal((n, d))
    return (x / np.abs(x).max()).astype(np.float32), mode


def scrna_like(n: int, seed: int = 0, d: int = 1000, modes: int = 8
               ) -> Labeled:
    """1000-d sparse non-negative expression counts (log1p of a
    zero-inflated gamma-Poisson), one of ``modes`` cell types a row;
    returns ``(x, z)``."""
    rng = np.random.default_rng(seed)
    base_rate = rng.gamma(0.3, 1.0, size=(modes, d))
    z = rng.integers(0, modes, size=n)
    lam = base_rate[z] * rng.gamma(2.0, 0.5, size=(n, 1))
    counts = rng.poisson(lam).astype(np.float32)
    mask = rng.uniform(size=(n, d)) < 0.85
    counts[mask] = 0.0
    return np.log1p(counts).astype(np.float32), z


GENERATORS: Dict[str, Callable[..., Labeled]] = {
    "mnist_like": mnist_like,
    "scrna_like": scrna_like,
}


def make(cfg: dict) -> Labeled:
    """The configuration's dataset: ``(x, labels)``."""
    return GENERATORS[cfg["dataset"]](
        int(cfg["n"]), seed=int(cfg["data_seed"]), d=int(cfg["d"]))
