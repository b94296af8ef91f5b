"""The port's dataset generators (``repro_torch.core.datasets``) against
the JAX package's (``repro.core.datasets``): the same numpy draws in the
same order, so every array is equal bit for bit, dtype and shape
included, at three (n, seed) pairs per generator and with the feature
width overridden."""

import numpy as np
import pytest

from repro.core import datasets as jdatasets
from repro_torch.core import datasets

NAMES = sorted(jdatasets.GENERATORS)
PAIRS = [(1, 0), (257, 3), (2000, 11)]


def _same(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_generators_have_the_jax_keys():
    assert sorted(datasets.GENERATORS) == NAMES
    assert "code_blobs" not in datasets.GENERATORS


@pytest.mark.parametrize("n,seed", PAIRS)
@pytest.mark.parametrize("name", NAMES)
def test_make_is_bit_equal_to_jax(name, n, seed):
    _same(datasets.make(name, n, seed), jdatasets.make(name, n, seed))
    _same(datasets.GENERATORS[name](n, seed=seed),
          jdatasets.GENERATORS[name](n, seed=seed))


@pytest.mark.parametrize("name,d", [("mnist_like", 24), ("scrna_like", 40),
                                    ("scrna_pca_like", 3),
                                    ("hoc4_like", 7)])
def test_width_override_is_bit_equal_to_jax(name, d):
    got = datasets.make(name, 300, seed=5, d=d)
    assert got.shape == (300, d)
    _same(got, jdatasets.make(name, 300, seed=5, d=d))


def test_regimes():
    """What each generator stands for: scRNA is sparse, non-negative
    log-counts; HOC4 small non-negative integers; the PCA regime has a
    few heavy-tailed outliers."""
    x = datasets.scrna_like(500, seed=0)
    assert x.shape == (500, 1000) and (x >= 0).all()
    assert 0.8 < float((x == 0).mean()) < 1.0
    h = datasets.hoc4_like(500, seed=0)
    assert h.shape == (500, 32) and (h >= 0).all()
    assert np.array_equal(h, np.round(h))
    p = datasets.scrna_pca_like(4000, seed=0)
    norms = np.linalg.norm(p, axis=1)
    assert norms.max() > 3 * np.median(norms)
