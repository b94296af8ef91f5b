"""Fits at k past 64 held against the JAX package on the CPU.

The port's SWAP kernels hold their cluster bins a chunk of 32 clusters
at a time, so no k is refused on the card; the reference's kernels pad
the one-hot to 128 lanes and take any k as well.  On the CPU the port
runs the plain versions, whose fit must still reproduce the JAX fit at
such a k: the same medoids, swap history, ledger and build rounds, the
loss to rtol 1e-5.

At k = 65 a fit makes some 300,000 kill decisions, so a fixture of
real-valued blobs puts a few of them on a float32 margin, where the two
packages' summation orders decide (the ledgers differ by a few
arm-rounds).  This fixture is integer-valued: 65 blobs at the corners of
an even-weight binary code scaled by 24, points within 1 of their center
on each of 8 coordinates (``datasets.code_blobs``).  Every l2sq distance
is then an integer, every batch sum of l2sq statistics an integer below
2^24 and so exact in any order; the l2 fit is held as the main path's
metric.
"""

import pytest
import torch

from repro.core import BanditPAM as JBanditPAM
from repro_torch import convert
from repro_torch.core import BanditPAM
from repro_torch.core.datasets import code_blobs
from test_torch_banditpam import _same_fit, jax_layouts
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("metric", ["l2", "l2sq"])
def test_fit_past_64_medoids_matches_jax_reference(metric):
    k = 65
    X = code_blobs(650, k, seed=3)
    n = X.shape[0]
    want = JBanditPAM(k, metric=metric, seed=0, backend="jnp").fit(X)
    layouts = convert.layouts_from_reference(*jax_layouts(0, n, k))
    got = BanditPAM(k, metric=metric, device="cpu").fit(X, layouts=layouts)
    _same_fit(got, want)
    assert len(set(got.medoids.tolist())) == k and got.n_swaps > 0
