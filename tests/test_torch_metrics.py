"""The port's non-kernel metrics against the JAX facade on the CPU:
``metric="precomputed"`` (an ``[n, n]`` matrix through ``attach_index``)
and raw callables (registered under a derived name), through fit,
transform and predict, with the errors the JAX package raises.

Chebyshev distances are exact in float32 (a max of exact differences),
so both packages see the same dissimilarities and the fits agree
exactly; the matrix of ``precomputed`` is the JAX package's own ``l2``
block, handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.core import datasets as jdatasets
from repro.core import distances as jdistances
from repro_torch.api import KMedoids
from repro_torch.core import BanditPAM, distances, engine
from torch_threads import one_intra_op_thread  # noqa: F401


def _cheb(x, y):
    return torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)


def _jcheb(x, y):
    return jnp.max(jnp.abs(x[:, None, :] - y[None, :, :]), axis=-1)


def _blocks(n=260, m=40):
    X = jdatasets.mnist_like(n + m, seed=3, d=24)
    D = np.array(jdistances.pairwise(X, X, metric="l2"))
    return X, D[:n, :n], D[n:, :n]


def _same(got, want):
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    assert got.evals_by_phase == want.evals_by_phase
    assert got.n_swaps == want.n_swaps
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)


def test_attach_index_matches_jax():
    D = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.testing.assert_array_equal(distances.attach_index(D).numpy(),
                                  np.asarray(jdistances.attach_index(D)))
    x = distances.attach_index(D)
    np.testing.assert_array_equal(
        distances.precomputed(x, x[[2, 0]]).numpy(),
        np.asarray(jdistances.precomputed(jnp.asarray(x.numpy()),
                                          jnp.asarray(x.numpy()[[2, 0]]))))


@pytest.mark.parametrize("solver,params", [
    ("banditpam", {}), ("banditpam", {"sampling": "replacement"}),
    ("pam", {}), ("fasterpam", {}), ("voronoi", {}), ("clara", {}),
    ("clarans", {"max_neighbors": 30}), ("onebatchpam", {"ref_size": 64})])
def test_precomputed_fit_transform_predict_match_jax(solver, params):
    _, D, Q = _blocks()
    jest = JKMedoids(3, solver=solver, metric="precomputed", seed=1,
                     **params).fit(D)
    est = KMedoids(3, solver=solver, metric="precomputed", seed=1,
                   device="cpu", **params).fit(D)
    _same(est.report_, jest.report_)
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    assert est.report_.metric == "precomputed"
    np.testing.assert_array_equal(est.transform(Q), jest.transform(Q))
    np.testing.assert_array_equal(est.predict(Q), jest.predict(Q))
    assert est.n_features_in_ == D.shape[0]


def test_precomputed_fit_equals_the_feature_fit():
    """The lookup serves the solvers the same distances as the metric."""
    X, D, _ = _blocks()
    a = KMedoids(3, metric="precomputed", seed=2, device="cpu").fit(D)
    b = KMedoids(3, metric="l2", seed=2, device="cpu").fit(X[:260])
    assert a.medoids_.tolist() == b.medoids_.tolist()


@pytest.mark.parametrize("solver", ["banditpam", "pam", "onebatchpam",
                                    "fasterpam"])
def test_callable_metric_matches_jax(solver):
    X = jdatasets.mnist_like(240, seed=5, d=24)
    Q = jdatasets.mnist_like(30, seed=6, d=24)
    jest = JKMedoids(3, solver=solver, metric=_jcheb, seed=4).fit(X)
    est = KMedoids(3, solver=solver, metric=_cheb, seed=4,
                   device="cpu").fit(X)
    _same(est.report_, jest.report_)
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    np.testing.assert_array_equal(est.transform(Q), jest.transform(Q))
    np.testing.assert_array_equal(est.predict(Q), jest.predict(Q))


def test_callables_register_without_clobbering():
    def l2(x, y):                                   # shares a builtin name
        return _cheb(x, y)
    name = distances.resolve_metric(l2)
    assert name != "l2" and name.startswith("l2_")
    assert distances.get_metric("l2") is distances.l2
    assert distances.resolve_metric(l2) == name      # same object, same name
    other = distances.resolve_metric(lambda x, y: _cheb(x, y))
    again = distances.resolve_metric(lambda x, y: _cheb(x, y))
    assert other != again and other.startswith("<lambda>")
    with pytest.raises(TypeError, match="callable"):
        distances.resolve_metric(3)
    with pytest.raises(KeyError):
        distances.resolve_metric("nope")


def test_precomputed_errors():
    _, D, Q = _blocks(60, 5)
    with pytest.raises(ValueError, match="square"):
        KMedoids(2, metric="precomputed", device="cpu").fit(D[:, :50])
    with pytest.raises(ValueError, match="square"):
        distances.attach_index(np.zeros((3, 4), np.float32))
    # A raw matrix handed past the facade: the index column is checked.
    with pytest.raises(ValueError, match="attach_index"):
        BanditPAM(2, metric="precomputed", device="cpu").fit(D)
    with pytest.raises(ValueError, match="attach_index"):
        distances.precomputed(torch.from_numpy(D), torch.from_numpy(D[:4]))
    est = KMedoids(2, metric="precomputed", device="cpu").fit(D)
    with pytest.raises(ValueError, match="n_fit=60"):
        est.transform(Q[:, :40])
    # No kernel serves the lookup or a callable: "auto" takes "torch" on
    # the card, an explicit "cuda" is refused.
    cuda = torch.device("cuda")
    for metric in ("precomputed", distances.resolve_metric(_cheb)):
        assert engine.resolve_stats_backend("auto", metric, cuda) == "torch"
        with pytest.raises(ValueError, match="has no kernel"):
            engine.resolve_stats_backend("cuda", metric, cuda)


def test_precomputed_size_limit(monkeypatch):
    monkeypatch.setattr(distances, "_MAX_PRECOMPUTED_N", 8)
    monkeypatch.setattr(jdistances, "_MAX_PRECOMPUTED_N", 8)
    for attach in (distances.attach_index, jdistances.attach_index):
        attach(np.zeros((7, 7), np.float32))
        with pytest.raises(ValueError, match="n < 8"):
            attach(np.zeros((8, 8), np.float32))
