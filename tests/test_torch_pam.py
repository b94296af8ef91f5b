"""The port's exact passes and exact PAM held against the JAX package on
the CPU.

* ``engine.exact_build_means`` / ``exact_swap_means`` (the torch
  backend's 512-column streaming walks) against the JAX engine's jnp
  versions at n = 650, past one reference tile.  Tolerance: rtol 1e-5
  plus atol ``sqrt(d·2^-24)·max|d|`` for l2 (the self-distance residue of
  every point's own column, as in ``test_torch_banditpam.py``) or
  ``1e-5·max|d|`` otherwise: each mean averages n terms of that size.
* ``pam`` / ``fastpam1`` against ``repro.core.pam.pam`` at the fit
  fixtures: medoids, swap history, ledger and convergence equal, loss to
  rtol 1e-5; and the ``KMedoids(solver="pam")`` facade's labels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.core import datasets as jdatasets
from repro.core import engine as jengine
from repro.core.pam import pam as jpam
from repro_torch.api import KMedoids
from repro_torch.core import engine, pam
from test_torch_banditpam import FIXTURES
from torch_threads import one_intra_op_thread  # noqa: F401


def _atol(metric, dmax, d):
    return (np.sqrt(d * 2.0 ** -24) if metric == "l2" else 1e-5) * dmax


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "l2sq"])
def test_exact_means_match_jax_engine(metric):
    n, k = 650, 4
    X = jdatasets.mnist_like(n, seed=2, d=48)
    data = torch.from_numpy(X)
    meds = np.array([3, 100, 400, 600])
    jbe = jengine.get_stats_backend("jnp")
    tbe = engine.get_stats_backend("torch")
    jd1, jd2, ja = jengine.medoid_cache(jnp.asarray(X),
                                        jnp.asarray(meds, np.int32),
                                        metric=metric)
    d1, d2, a = (torch.from_numpy(np.array(t)) for t in (jd1, jd2, ja))
    dmax = float(d2.max())
    want = np.asarray(jengine.exact_swap_means(jbe, jnp.asarray(X), jd1, jd2,
                                               ja, k, metric=metric))
    got = engine.exact_swap_means(tbe, data, d1, d2, a, k, metric=metric)
    assert got.shape == (k * n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=_atol(metric, dmax, X.shape[1]))
    for dnear in (d1, torch.full((n,), float("inf"))):
        want = np.asarray(jengine.exact_build_means(
            jbe, jnp.asarray(X), jnp.asarray(dnear.numpy()), metric=metric))
        got = engine.exact_build_means(tbe, data, dnear, metric=metric)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=_atol(metric, dmax, X.shape[1]))


@pytest.mark.parametrize("fastpam1", [True, False])
@pytest.mark.parametrize("n,k,metric", FIXTURES)
def test_pam_matches_jax_reference(n, k, metric, fastpam1):
    X = jdatasets.mnist_like(n, seed=1)
    want = jpam(X, k, metric=metric, fastpam1=fastpam1)
    got = pam(X, k, metric=metric, fastpam1=fastpam1, device="cpu")
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    assert got.evals_by_phase == want.evals_by_phase
    assert got.distance_evals == want.distance_evals
    assert (got.n_swaps, got.converged) == (want.n_swaps, want.converged)
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
    assert got.wall_by_phase.keys() == {"build", "swap"}


@pytest.mark.parametrize("solver", ["pam", "fastpam1"])
def test_kmedoids_pam_labels_match_jax(solver):
    n, k = 300, 3
    X = jdatasets.mnist_like(n, seed=1)
    jest = JKMedoids(k=k, solver=solver, metric="l2").fit(X)
    est = KMedoids(k=k, solver=solver, metric="l2", device="cpu").fit(X)
    assert est.medoids_.tolist() == np.asarray(jest.medoids_).tolist()
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    assert est.report_.solver == solver
    assert est.report_.evals_by_phase == jest.report_.evals_by_phase
    assert abs(est.loss_ - jest.loss_) <= 1e-5 * abs(jest.loss_)


def test_pam_refuses_bad_input():
    X = jdatasets.mnist_like(40, seed=0, d=16)
    with pytest.raises(ValueError, match="n > k"):
        pam(X[:3], 3, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        pam(X, 2, backend="cuda", device="cpu")
