"""The port's OneBatchPAM (``repro_torch.core.onebatch``) held against the
JAX package's on the CPU, through the solver and the ``KMedoids``
facade.

The reference batch is ``choice(PRNGKey(seed), n, (b,), replace=False)``
in both packages (the port's threefry), so no draws are passed in:
medoids, swap history, ``n_swaps``, ``distance_evals``,
``evals_by_phase`` and ``converged`` must be equal; the loss and the
swap history's batch losses agree to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.core import datasets as jdatasets
from repro.core import onebatch as jonebatch
from repro_torch.api import KMedoids
from repro_torch.core import onebatch, threefry
from torch_threads import one_intra_op_thread  # noqa: F401


def _same(got, want):
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    for (_, _, lg), (_, _, lw) in zip(got.swap_history, want.swap_history):
        assert abs(lg - lw) <= 1e-5 * abs(lw)
    assert got.n_swaps == want.n_swaps
    assert got.distance_evals == want.distance_evals
    assert got.evals_by_phase == want.evals_by_phase
    assert got.converged == want.converged
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)


@pytest.mark.parametrize("n,k,metric", [(400, 4, "l2"), (300, 3, "l1"),
                                        (350, 5, "cosine"),
                                        (300, 6, "l2sq")])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("ref_size", [None, 64])
def test_onebatchpam_matches_jax(n, k, metric, seed, ref_size):
    X = jdatasets.mnist_like(n, seed=1)
    want = jonebatch.onebatchpam(X, k, metric=metric, seed=seed,
                                 ref_size=ref_size, backend="jnp")
    got = onebatch.onebatchpam(X, k, metric=metric, seed=seed,
                               ref_size=ref_size, device="cpu")
    _same(got, want)
    assert got.converged


@pytest.mark.parametrize("init", [[0, 1, 2, 3], [399, 17, 250, 100]])
def test_onebatchpam_warm_start_matches_jax(init):
    X = jdatasets.mnist_like(400, seed=2)
    want = jonebatch.onebatchpam(X, 4, seed=3, init=init, backend="jnp")
    got = onebatch.onebatchpam(X, 4, seed=3, init=init, device="cpu")
    _same(got, want)
    assert got.n_swaps > 0


def test_onebatchpam_swap_budget_and_whole_batch():
    """``max_swaps`` cuts the SWAP loop (not converged); ``ref_size`` past
    n clamps to n."""
    X = jdatasets.mnist_like(200, seed=4)
    kw = dict(seed=1, init=[0, 1, 2], max_swaps=1)
    want = jonebatch.onebatchpam(X, 3, backend="jnp", **kw)
    got = onebatch.onebatchpam(X, 3, device="cpu", **kw)
    _same(got, want)
    assert got.n_swaps == 1 and not got.converged
    want = jonebatch.onebatchpam(X, 3, ref_size=10 ** 6, backend="jnp")
    got = onebatch.onebatchpam(X, 3, ref_size=10 ** 6, device="cpu")
    _same(got, want)
    assert got.evals_by_phase["ref_batch"] == 200 * 200


def test_onebatch_batch_is_the_jax_choice():
    import jax
    for seed, n, b in ((0, 60000, 256), (5, 300, 256), (2, 1000, 1000)):
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                            shape=(b,), replace=False))
        got = threefry.choice(threefry.PRNGKey(seed), n, (b,), replace=False)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw,match", [
    ({"init": [0, 1]}, "distinct"), ({"init": [0, 1, 1]}, "distinct"),
    ({"init": [0, 1, 500]}, "out of range"), ({"ref_size": 0}, ">= 1")])
def test_onebatchpam_rejects_bad_arguments(kw, match):
    X = jdatasets.mnist_like(100, seed=0, d=16)
    with pytest.raises(ValueError, match=match):
        jonebatch.onebatchpam(X, 3, **kw)
    with pytest.raises(ValueError, match=match):
        onebatch.onebatchpam(X, 3, device="cpu", **kw)
    with pytest.raises(ValueError, match="n > k"):
        onebatch.onebatchpam(X[:3], 3, device="cpu")


def test_facade_matches_jax():
    X = jdatasets.mnist_like(300, seed=7)
    jest = JKMedoids(4, solver="onebatchpam", seed=2, backend="jnp",
                     ref_size=80).fit(X)
    est = KMedoids(4, solver="onebatchpam", seed=2, device="cpu",
                   ref_size=80).fit(X)
    _same(est.report_, jest.report_)
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    jwarm = JKMedoids(4, solver="onebatchpam", seed=2, backend="jnp",
                      init=jest.medoids_[::-1].tolist()).fit(X)
    warm = KMedoids(4, solver="onebatchpam", seed=2, device="cpu",
                    init=est.medoids_[::-1].tolist()).fit(X)
    _same(warm.report_, jwarm.report_)
