"""The port's predict buckets and cached callables
(``repro_torch.api.predict``: ``bucket_rows``, ``assign_rows``,
``get_predict_fn``, ``get_assign_fn``) against the JAX package's
(``repro.api.predict``) on the CPU, where each callable is the eager
closure; their CUDA graphs are held on the card by
``tests/test_torch_cuda_serve.py``.

Tolerances: labels exactly; distances within rtol 1e-5 plus
1e-5·max|d|, and for l2 plus ``sqrt(d·2^-24)·max|d|`` (a medoid row's
own distance is the square root of l2sq summation noise:
``tests/test_torch_banditpam.py::test_assign_and_distances_match_jax``).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import predict as jpredict
from repro.core import datasets as jdatasets
from repro_torch.api import predict
from repro_torch.core import engine
from repro_torch.serve import MedoidService

CPU = torch.device("cpu")
K, D = 4, 12
METRICS = ["l2", "l1", "cosine", "l2sq"]
RAGGED = [1, 3, 64, 65, 200, 257]


def _atol(metric, dist, d):
    dmax = float(np.abs(dist).max())
    return 1e-5 * dmax + (np.sqrt(d * 2.0 ** -24) * dmax if metric == "l2"
                          else 0.0)


@pytest.mark.parametrize("chunk", [1, 2, 7, 64, 1000, 8192])
def test_buckets_equal_the_jax_functions(chunk):
    for m in list(range(0, 70)) + [127, 128, 129, 1000, 4097, 10 ** 6]:
        assert predict.bucket_rows(m, chunk) == jpredict.bucket_rows(m, chunk)
        assert predict.assign_rows(m) == jpredict.assign_rows(m)


@pytest.mark.parametrize("getter", ["get_predict_fn", "get_assign_fn"])
def test_callables_are_cached_and_bucketed(getter):
    """As ``tests/test_serve.py::test_predict_closure_is_cached_and_bucketed``:
    the same key gives the same callable, another bucket, backend or
    device another."""
    get = getattr(predict, getter)
    f1 = get(K, D, "l2", "torch", 256, CPU)
    assert f1 is get(K, D, "l2", "torch", 256, CPU)
    assert f1 is not get(K, D, "l2", "torch", 512, CPU)
    assert f1 is not get(K, D, "l1", "torch", 256, CPU)
    assert f1 is not get(K + 1, D, "l2", "torch", 256, CPU)
    assert f1.rows == 256 and f1.device == CPU


def test_resolved_backends_never_alias():
    """``"auto"`` is resolved before a getter is called: predict through
    ``backend="auto"`` and ``"torch"`` on the CPU reach one callable."""
    X = jdatasets.mnist_like(40, seed=1, d=D)
    seen = []
    real = predict.get_assign_fn

    def spy(*key):
        seen.append(key)
        return real(*key)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(predict, "get_assign_fn", spy)
        for be in (None, "auto", "torch"):
            predict.assign_medoids(X, X[:K], "l2", backend=be, device="cpu")
    assert len(set(seen)) == 1 and seen[0][3] == "torch"


def test_eager_callables_take_the_unpadded_request(monkeypatch):
    """Off the kernel backend's graphs nothing is padded: the backend
    sees each request (each chunk of ``medoid_distances``) as it is, and
    the callable returns its rows."""
    got = []

    class Recording(engine.TorchStatsBackend):
        def top2(self, x, med_pts, *, metric):
            got.append(x.clone())
            return super().top2(x, med_pts, metric=metric)

        def pairwise(self, x, y, *, metric, out=None, run=None):
            got.append(x.clone())
            return super().pairwise(x, y, metric=metric, out=out, run=run)

    monkeypatch.setitem(engine._BACKENDS, "recording", Recording())
    X = jdatasets.mnist_like(100, seed=2, d=D)
    labels, dmin = predict.assign_medoids(X[:37], X[:K], "l2",
                                          backend="recording", device="cpu")
    dist = predict.medoid_distances(X[:37], X[:K], "l2", backend="recording",
                                    device="cpu", chunk=16)
    assert labels.shape == dmin.shape == (37,) and dist.shape == (37, K)
    assert [tuple(x.shape) for x in got] == [(37, D), (16, D), (16, D),
                                             (5, D)]
    for x, lo in zip(got, (0, 0, 16, 32)):
        np.testing.assert_array_equal(x.numpy(), X[lo:lo + x.shape[0]])


def test_assign_chunk_bounds_the_largest_bucket():
    """The largest assignment bucket: a power of two of rows, at most
    ``DEFAULT_CHUNK``, whose input holds at most ``ASSIGN_MAX_ELEMS``
    floats."""
    for d in (1, 16, 784, 1000, 1025, 151_936, 10 ** 8):
        rows = predict.assign_chunk(d)
        assert rows & (rows - 1) == 0 and 1 <= rows <= predict.DEFAULT_CHUNK
        assert rows == 1 or rows * d <= predict.ASSIGN_MAX_ELEMS
        assert (rows == predict.DEFAULT_CHUNK
                or 2 * rows * d > predict.ASSIGN_MAX_ELEMS)
    assert predict.assign_chunk(784) == 8192
    assert predict.assign_chunk(151_936) == 32


def test_large_assignments_walk_the_largest_bucket(monkeypatch):
    """A request past ``assign_chunk(d)`` rows goes through buckets of at
    most that many, with the result of one pass: equal to the JAX
    function's and, bit for bit, to the same request in one bucket."""
    X = jdatasets.mnist_like(300, seed=5, d=D)
    med = X[[4, 90, 150, 260]]
    whole = predict.assign_medoids(X, med, "l1", device="cpu")
    keys = []
    real = predict.get_assign_fn
    monkeypatch.setattr(predict, "get_assign_fn",
                        lambda *key: keys.append(key) or real(*key))
    monkeypatch.setattr(predict, "ASSIGN_MAX_ELEMS", 64 * D)
    assert predict.assign_chunk(D) == 64
    labels, dmin = predict.assign_medoids(X, med, "l1", device="cpu")
    assert [k[4] for k in keys] == [64, 64, 64, 64, 64]
    np.testing.assert_array_equal(labels, whole[0])
    assert dmin.tobytes() == whole[1].tobytes()
    jl, jd = jpredict.assign_medoids(X, jnp.asarray(med), "l1",
                                     backend="jnp")
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(dmin, jd, rtol=1e-5, atol=_atol("l1", jd, D))


@pytest.mark.parametrize("getter", ["get_predict_fn", "get_assign_fn"])
def test_callables_are_keyed_on_the_normalised_device_and_bounded(getter):
    """One entry for one device however it is named; at most
    ``MAX_CALLABLES`` entries, the least recently used dropped."""
    get = getattr(predict, getter)
    get.cache_clear()
    f1 = get(K, D, "l2", "torch", 16, "cpu")
    assert f1 is get(K, D, "l2", "torch", 16, CPU)
    for k in range(1, predict.MAX_CALLABLES + 5):
        get(k + K, D, "l2", "torch", 16, CPU)
    assert get.cache_info().currsize == predict.MAX_CALLABLES
    assert f1 is not get(K, D, "l2", "torch", 16, CPU)


@pytest.mark.parametrize("metric", METRICS)
def test_ragged_requests_match_jax(metric):
    X = jdatasets.mnist_like(400, seed=4, d=D)
    med = X[[3, 50, 77, 120]]
    for m in RAGGED:
        q = X[100:100 + m]
        jl, jd = jpredict.assign_medoids(q, jnp.asarray(med), metric,
                                         backend="jnp")
        tl, td = predict.assign_medoids(q, med, metric, device="cpu")
        assert tl.dtype == np.int32 and td.dtype == np.float32
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, rtol=1e-5,
                                   atol=_atol(metric, jd, D))
        jm = jpredict.medoid_distances(q, jnp.asarray(med), metric,
                                       backend="jnp", chunk=64)
        tm = predict.medoid_distances(q, med, metric, device="cpu", chunk=64)
        assert tm.shape == (m, K)
        np.testing.assert_allclose(tm, jm, rtol=1e-5,
                                   atol=_atol(metric, jm, D))
        # The predict callable's labels and dmin are its block's.
        fn = predict.get_predict_fn(K, D, metric, "torch",
                                    predict.bucket_rows(m, 64), CPU)
        dist, lab, dmn = fn(q[:64], torch.from_numpy(med))
        assert torch.equal(lab, torch.argmin(dist, dim=1).to(torch.int32))
        assert torch.equal(dmn, dist.min(dim=1).values)


def test_empty_requests():
    X = jdatasets.mnist_like(10, seed=0, d=D)
    labels, dmin = predict.assign_medoids(X[:0], X[:K], "l2", device="cpu")
    assert labels.shape == dmin.shape == (0,)
    assert predict.medoid_distances(X[:0], X[:K], "l2",
                                    device="cpu").shape == (0, K)
    with pytest.raises(ValueError, match="queries"):
        predict.assign_medoids(X[:, :3], X[:K], "l2", device="cpu")


def test_assign_chunk_is_ignored_and_warns_once(monkeypatch):
    """``chunk=`` is accepted and ignored, with one DeprecationWarning a
    process, as in the JAX package: each side called twice warns once."""
    monkeypatch.setattr(jpredict, "_chunk_deprecation_warned", False)
    monkeypatch.setattr(predict, "_chunk_deprecation_warned", False)
    X = jdatasets.mnist_like(150, seed=6, d=D)
    med = X[:K]
    out = {}
    for name, call in (
            ("jax", lambda: jpredict.assign_medoids(
                X, jnp.asarray(med), "l2", backend="jnp", chunk=64)),
            ("port", lambda: predict.assign_medoids(
                X, med, "l2", chunk=64, device="cpu"))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[name] = [call(), call()]
        dep = [w for w in caught if issubclass(w.category,
                                               DeprecationWarning)]
        assert len(dep) == 1, (name, [str(w.message) for w in caught])
        assert "chunk" in str(dep[0].message)
    for (jl, jd), (tl, td) in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, rtol=1e-5,
                                   atol=_atol("l2", jd, D))
    unchunked = predict.assign_medoids(X, med, "l2", device="cpu")
    np.testing.assert_array_equal(out["port"][0][0], unchunked[0])
    assert out["port"][0][1].tobytes() == unchunked[1].tobytes()


def test_service_answers_through_the_cached_callables(monkeypatch):
    """``MedoidService`` reaches the buckets through ``assign_medoids``
    and ``medoid_distances``: ragged requests share their buckets'
    callables."""
    keys = []
    for getter in ("get_assign_fn", "get_predict_fn"):
        real = getattr(predict, getter)
        monkeypatch.setattr(predict, getter,
                            lambda *key, real=real: keys.append(key)
                            or real(*key))
    X = jdatasets.mnist_like(300, seed=7, d=D)
    svc = MedoidService(K, "l2", device="cpu").fit(X)
    keys.clear()
    for m in (5, 7, 8, 100, 128):
        svc.predict(X[:m])
    svc.transform(X[:33])
    assert [k[4] for k in keys] == [8, 8, 8, 128, 128, 64]
    assert {k[3] for k in keys} == {"torch"}
