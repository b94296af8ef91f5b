"""The serving layer on the card: a ``"cuda"`` ``MedoidService`` against
a ``"torch"`` one on the card, warm-started fits, snapshot and resume,
the reservoir's draws, and predict's CUDA graphs (``repro_torch.api.
predict``): graph bits equal to eager launches on the unpadded request,
each replay counted as a launch of the kernels it holds, no new capture
for a bucket already captured, the rows a larger request left zeroed,
a capture that meets a sync raising, a bucket's result unchanged by
another bucket's replay before it is read, one cache entry however the
device is named, large assignments walking the largest bucket, the
``"torch"`` backend and a callable metric staying eager, and predict's
budgets counting the graphs' buffers.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device (decided inside the fixture, never at import).  Run on the
card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_serve.py``.

The services run on ``datasets.code_blobs``, integer points whose l2
distances both backends compute exactly, so the kernels and the plain
versions see the same distances: the refits trip at the same chunks and
land on the same medoids, labels and nearest distances are equal bit for
bit, and the ledgers agree within the allowance ``chip_smoke.py`` phase
4 gives the cache modes, 2·n·B per entry (a kill on an exact float32
margin can end a search a round later: ROADMAP §C).
"""

import numpy as np
import pytest
import torch

from repro_torch.api import predict
from repro_torch.core import BanditPAM, datasets, engine, threefry
from repro_torch.kernels import ops
from repro_torch.serve import MedoidService
from repro_torch.serve.reservoir import stream_uniforms

pytestmark = pytest.mark.gpu

K, N, B = 10, 4000, 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fit_rows():
    return datasets.code_blobs(N, K, seed=6)


def _stream():
    # Blobs around other centres: the monitor trips.
    return datasets.code_blobs(N, K, seed=7)


def _ledgers_close(a, b, n):
    assert a.evals_by_phase.keys() == b.evals_by_phase.keys()
    assert all(abs(v - b.evals_by_phase[p]) <= 2 * n * B
               for p, v in a.evals_by_phase.items())


def _serve(svc, stream, step=500):
    """Ingest ``stream``; returns (labels, dmin, refit positions,
    refit reports)."""
    labels, dmin, trips, reports = [], [], [], []
    for lo in range(0, len(stream), step):
        r = svc.ingest(stream[lo:lo + step])
        labels.append(r.labels)
        dmin.append(r.dmin)
        if r.refit is not None:
            trips.append(lo)
            reports.append(r.refit)
    return np.concatenate(labels), np.concatenate(dmin), trips, reports


@pytest.mark.parametrize("kw,kernels", [
    ({}, ("top2", "pairwise", "swap_g_from_cache")),
    ({"solver": "banditpam", "refit_params": {"reuse": "none"}},
     ("top2", "build_g", "swap_g")),
])
def test_cuda_service_matches_torch(cuda, kw, kernels):
    """The defaults (BanditPAM++ fit, warm PIC refits) and a plain
    BanditPAM fit with ``reuse="none"`` warm refits, which put build_g
    and swap_g on the serving path."""
    out = {}
    for be in ("cuda", "torch"):
        ops.reset_launch_counts()
        svc = MedoidService(K, "l2", backend=be, device=cuda, **kw)
        svc.fit(_fit_rows())
        out[be] = (svc, *_serve(svc, _stream()), ops.launch_counts())
    (a, la, da, ta, ra, counts), (b, lb, db, tb, rb, plain) = (
        out["cuda"], out["torch"])
    assert ta and ta == tb
    np.testing.assert_array_equal(la, lb)
    assert da.tobytes() == db.tobytes()
    for x, y in zip(ra, rb):
        assert x.medoids.tolist() == y.medoids.tolist()
        assert x.evals_by_phase["build"] == 0
        _ledgers_close(x, y, K + len(a.reservoir))
    assert a.medoid_points.cpu().numpy().tobytes() == \
        b.medoid_points.cpu().numpy().tobytes()
    assert np.array_equal(a.reservoir.sidx, b.reservoir.sidx)
    assert min(counts[nm] for nm in kernels) >= 1, counts
    assert not any(plain.values()), plain


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_warm_start_fit_cuda_matches_torch(cuda, reuse):
    X = torch.from_numpy(datasets.code_blobs(2048, 8, seed=19)).to(cuda)
    kw = {"reuse": reuse}
    if reuse == "pic":
        kw["cache_width"] = 10 * B           # half of the 21 rounds: recycles
    ws = np.arange(8) * 97 + 3
    fits = {be: BanditPAM(8, seed=4, backend=be, device=cuda, **kw).fit(
        X, warm_start=ws) for be in ("cuda", "torch")}
    a, b = fits["cuda"], fits["torch"]
    assert a.medoids.tolist() == b.medoids.tolist()
    assert [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
    assert a.evals_by_phase["build"] == 0 and a.n_swaps > 0
    _ledgers_close(a, b, 2048)
    assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)


def test_snapshot_on_the_card_resumes_bit_identical(cuda, tmp_path):
    svc = MedoidService(K, "l2", device=cuda).fit(_fit_rows())
    stream = _stream()
    _serve(svc, stream[:1500])
    svc.snapshot(str(tmp_path))
    back = MedoidService.restore(str(tmp_path), device=cuda)
    assert back.medoid_points.device.type == cuda.type
    assert back.stats() == svc.stats()
    # The rest of the stream, then blobs around a third set of centres.
    rest = np.concatenate([stream[1500:], datasets.code_blobs(2000, K,
                                                              seed=8)])
    la, da, ta, _ = _serve(svc, rest)
    lb, db, tb, _ = _serve(back, rest)
    assert ta and ta == tb
    np.testing.assert_array_equal(la, lb)
    assert da.tobytes() == db.tobytes()
    assert back.stats() == svc.stats()
    assert back.medoid_points.cpu().numpy().tobytes() == \
        svc.medoid_points.cpu().numpy().tobytes()
    for key, v in svc.reservoir.state().items():
        assert np.asarray(back.reservoir.state()[key]).tobytes() == \
            np.asarray(v).tobytes()


def test_reservoir_uniforms_card_equal_cpu(cuda):
    idx = np.concatenate([np.arange(60000), 2 ** 31 - 5 + np.arange(10),
                          2 ** 32 - 5 + np.arange(10)]).astype(np.int64)
    for seed in (0, 2 ** 31 + 7):
        key = threefry.PRNGKey(seed)
        got = threefry.uniform(threefry.fold_in(
            key, torch.as_tensor(idx, device=cuda)))
        assert got.is_cuda
        assert torch.equal(got.cpu(), stream_uniforms(key, idx))


def _eager_assign(q, med, metric):
    """The eager path the graphs replace: the unpadded request uploaded,
    one ``top2`` launch, labels and dmin bits."""
    d1, _, labels = ops.stream_top2(q, med, metric=metric)
    return labels.cpu().numpy(), d1.cpu().numpy()


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "l2sq"])
def test_graph_requests_equal_eager(cuda, metric):
    X = datasets.mnist_like(6000, seed=1, d=40)
    med = torch.from_numpy(X[[5, 900, 1800, 2700, 3600, 4500, 5400]]).to(
        cuda)
    for m in (1, 3, 256, 257, 1000, 4097, 100):
        q = X[:m]
        labels, dmin = predict.assign_medoids(q, med, metric, device=cuda)
        want_l, want_d = _eager_assign(torch.from_numpy(q).to(cuda), med,
                                       metric)
        np.testing.assert_array_equal(labels, want_l)
        assert dmin.tobytes() == want_d.tobytes()
        # A request already on the card takes the device-to-device copy.
        got = predict.assign_medoids(torch.from_numpy(q).to(cuda), med,
                                     metric, device=cuda)
        assert got[1].tobytes() == want_d.tobytes()
        dist = predict.medoid_distances(q, med, metric, device=cuda,
                                        chunk=512)
        want = ops.pairwise_distance(torch.from_numpy(q).to(cuda), med,
                                     metric)
        assert dist.tobytes() == want.cpu().numpy().tobytes()


def test_replays_are_counted_and_buckets_not_recaptured(cuda):
    X = datasets.mnist_like(3000, seed=2, d=24)
    med = torch.from_numpy(X[:9]).to(cuda)
    sizes = (100, 128, 65, 1000, 1024, 513, 100)
    ops.reset_launch_counts()
    for m in sizes:
        predict.assign_medoids(X[:m], med, "l2", device=cuda)
    counts = ops.launch_counts()
    assert counts["top2"] == len(sizes), counts
    assert sum(counts.values()) == len(sizes), counts
    dev = predict._device_key(cuda)
    fns = {r: predict.get_assign_fn(9, 24, "l2", "cuda", r, dev)
           for r in (128, 1024)}
    assert fns[128].replays == 4 and fns[1024].replays == 3
    graphs = {r: fn.graph for r, fn in fns.items()}
    info = predict.get_assign_fn.cache_info()
    for m in (90, 700):
        predict.assign_medoids(X[:m], med, "l2", device=cuda)
    assert predict.get_assign_fn.cache_info().currsize == info.currsize
    assert all(fns[r].graph is graphs[r] for r in fns)
    assert ops.launch_counts()["top2"] == len(sizes) + 2
    # The predict graphs count pairwise the same way.
    ops.reset_launch_counts()
    predict.medoid_distances(X[:300], med, "l2", device=cuda, chunk=128)
    assert ops.launch_counts()["pairwise"] == 3


def test_stale_rows_are_zeroed(cuda):
    X = datasets.mnist_like(200, seed=3, d=16)
    med = torch.from_numpy(X[:4]).to(cuda)
    predict.assign_medoids(X[:120], med, "l1", device=cuda)
    # 70 rows: the same 128-row bucket.
    labels, dmin = predict.assign_medoids(X[120:190], med, "l1",
                                          device=cuda)
    fn = predict.get_assign_fn(4, 16, "l1", "cuda", 128,
                               predict._device_key(cuda))
    assert fn.replays == 2
    assert not fn._x[70:].any()
    want = _eager_assign(torch.from_numpy(X[120:190]).to(cuda), med, "l1")
    np.testing.assert_array_equal(labels, want[0])
    assert dmin.tobytes() == want[1].tobytes()


def test_a_capture_that_syncs_raises(cuda, monkeypatch):
    """No fallback: a kernel backend whose body reads the device inside
    the capture fails the getter."""
    class Syncing(engine.CudaStatsBackend):
        def top2(self, x, med_pts, *, metric):
            out = super().top2(x, med_pts, metric=metric)
            float(out[0].sum())
            return out

    monkeypatch.setitem(engine._BACKENDS, "syncing", Syncing())
    X = datasets.mnist_like(50, seed=4, d=16)
    with pytest.raises(RuntimeError):
        predict.assign_medoids(X, X[:3], "l2", backend="syncing",
                               device=cuda)


def test_another_buckets_replay_leaves_a_result_alone(cuda):
    """Two buckets of one pool, the smaller captured first: a result of
    the larger one is a copy, so a replay of the smaller one before the
    result is read leaves it as it was."""
    predict.clear_callables()
    X = datasets.mnist_like(2000, seed=5, d=32)
    med = torch.from_numpy(X[:6]).to(cuda)
    dev = predict._device_key(cuda)
    small = predict.get_predict_fn(6, 32, "l2", "cuda", 128, dev)
    large = predict.get_predict_fn(6, 32, "l2", "cuda", 1024, dev)
    want = ops.pairwise_distance(torch.from_numpy(X[:1000]).to(cuda), med,
                                 "l2")
    dist, labels, dmin = large(X[:1000], med)
    small(X[1000:1100] + 7.0, med)
    torch.cuda.synchronize()
    assert torch.equal(dist, want)
    assert torch.equal(labels, torch.argmin(want, dim=1).to(torch.int32))
    assert torch.equal(dmin, want.amin(dim=1))


def test_one_entry_whatever_the_device_is_called(cuda):
    fns = [predict.get_assign_fn(3, 8, "l2", "cuda", 64, dev)
           for dev in (None, "cuda", "cuda:0", torch.device("cuda", 0))]
    assert all(f is fns[0] for f in fns)


def test_large_assignments_walk_the_largest_bucket(cuda, monkeypatch):
    """A request of more than ``assign_chunk(d)`` rows: one graph replay
    a chunk of that many, bits equal to one eager ``top2`` launch."""
    d = 1024
    step = predict.assign_chunk(d)
    assert step == 8192
    X = np.random.default_rng(6).standard_normal((2 * step + 300, d),
                                                 dtype=np.float32)
    med = torch.from_numpy(X[[1, 700, 9000, 16000]]).to(cuda)
    rows = []
    real = predict.get_assign_fn
    monkeypatch.setattr(predict, "get_assign_fn",
                        lambda *key: rows.append(key[4]) or real(*key))
    ops.reset_launch_counts()
    labels, dmin = predict.assign_medoids(X, med, "l2", device=cuda)
    assert rows == [step, step, 512]
    assert ops.launch_counts()["top2"] == 3
    want = _eager_assign(torch.from_numpy(X).to(cuda), med, "l2")
    np.testing.assert_array_equal(labels, want[0])
    assert dmin.tobytes() == want[1].tobytes()


def test_torch_backend_and_callable_metrics_stay_eager(cuda):
    """Only the kernel backend's kernel metrics are captured: the
    ``"torch"`` backend on the card and a callable metric run eagerly,
    as before the graphs, and a callable that reads the device still
    works."""
    X = datasets.mnist_like(600, seed=7, d=20)
    med = torch.from_numpy(X[:5]).to(cuda)
    fn = predict.get_assign_fn(5, 20, "l2", "torch", 64,
                               predict._device_key(cuda))
    assert not hasattr(fn, "graph")
    labels, dmin = predict.assign_medoids(X[:50], med, "l2",
                                          backend="torch", device=cuda)
    want = torch.cdist(torch.from_numpy(X[:50]).to(cuda), med)
    np.testing.assert_array_equal(labels, want.argmin(dim=1).cpu().numpy())

    reads = []

    def cheb(x, y):
        out = torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
        reads.append(float(out.max()))        # a read of the device
        return out
    from repro_torch.api import KMedoids
    est = KMedoids(4, metric=cheb, seed=0, device=cuda).fit(X)
    cpu = KMedoids(4, metric=cheb, seed=0, device="cpu").fit(X)
    got = est.predict(X[:70])
    assert got.tolist() == cpu.predict(X[:70]).tolist()
    assert reads


def test_predict_budgets_count_the_graphs(cuda):
    """``budgets.measure`` captures predict's graphs inside the measured
    call: their static input is counted, not hidden by a warm cache."""
    from repro_torch.analysis import budgets
    for name in ("api.medoid_distances", "api.assign_medoids"):
        m = budgets.measure(name, device=cuda)
        rows = m.shape["rows"]
        if name == "api.assign_medoids":
            rows = predict.assign_chunk(m.shape["d"])
        assert m.temp >= rows * m.shape["d"] * 4, m
        assert m.temp <= m.bound, (m, budgets.budget_doc(name))
