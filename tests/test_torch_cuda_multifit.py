"""The lane kernels and ``fit_batch`` on the card.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device.  Run on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_multifit.py``.

* ``build_g``, ``swap_g`` and ``top2`` with a lane axis: every running
  lane of a ragged lane launch equals the single launch on its own slice
  bit for bit (the lane axis is a grid dimension over the single kernel's
  body), and a lane whose run flag reads 0 leaves its outputs unwritten;
* ``fit_batch`` with ``backend="cuda"`` equals the loop of single
  ``backend="cuda"`` fits bit for bit (loss bits included), in both
  ``reuse`` modes and with the leader, launching ``build_g_lanes`` /
  ``swap_g_lanes`` once a round and no single round kernel;
* a batch of identical lanes reads and launches what one fit does;
* ``backend="cuda"`` against ``"torch"`` on ``code_blobs``, whose integer
  l2sq distances give both backends the same distances;
* the PIC batch's lane kernels, ``pairwise`` (into each lane's ring slot
  or scratch columns, and the ``d_near`` rows) and ``swap_g_from_cache``
  (from each lane's block, and over the whole rings as the repair), equal
  single launches bit for bit with one lane's run flag at 0, and the
  served BUILD statistics of the lanes (plain math with a lane axis)
  equal the single form's per lane; a PIC ``fit_batch`` whose lanes
  recycle and carry equals its loop under both baselines, and identical
  PIC lanes launch and read like one fit.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import KMedoids
from repro_torch.core import BanditPAM, banditpam, datasets, engine
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

ROWS = [1000, 130, 777, 512]
B = 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lanes(dev, d=784, b=B, seed=0):
    rng = np.random.default_rng(seed)
    n_pad = -(-max(ROWS) // 16) * 16
    x = torch.zeros((len(ROWS), n_pad, d), device=dev)
    for i, n in enumerate(ROWS):
        x[i, :n] = torch.from_numpy(datasets.mnist_like(n, seed=seed + i,
                                                        d=d)).to(dev)
    ref = torch.from_numpy(np.stack([rng.integers(0, n, b)
                                     for n in ROWS])).to(dev)
    y = torch.stack([x[i, ref[i]] for i in range(len(ROWS))]).contiguous()
    w = torch.ones((len(ROWS), b), device=dev)
    w[:, -9:] = 0.0
    lg = torch.from_numpy(rng.standard_normal((len(ROWS), b)).astype(
        np.float32)).to(dev)
    rows = torch.tensor(ROWS, dtype=torch.int32, device=dev)
    run = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    return x, y, w, lg, rows, run, rng


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_build_g_lanes_equal_single_launches(cuda, metric):
    x, y, w, lg, rows, run, rng = _lanes(cuda)
    dn = torch.from_numpy((rng.uniform(0.2, 1.0, w.shape)).astype(
        np.float32)).to(cuda)
    dn[:, :11] = float("inf")
    got = ops.build_g_lanes_stats(x, y, dn, w, lg, rows=rows, metric=metric,
                                  run=run)
    for i, n in enumerate(ROWS):
        if not run[i]:
            continue
        one = ops.build_g_stats(x[i, :n].contiguous(), y[i], dn[i], w[i],
                                lg[i], metric=metric)
        for g, o in zip(got, one):
            assert torch.equal(g[i, :n], o), (metric, i)


@pytest.mark.parametrize("k,b", [(3, 100), (10, 100), (65, 100), (10, 300)])
def test_swap_g_lanes_equal_single_launches(cuda, k, b):
    """b = 300 takes the kernel's scratch path (bins across column tiles),
    which the lane axis indexes by (lane, block)."""
    x, y, w, lg, rows, run, rng = _lanes(cuda, b=b, seed=k)
    d1 = torch.from_numpy(rng.uniform(0.1, 0.6, w.shape).astype(
        np.float32)).to(cuda)
    d2 = d1 + torch.from_numpy(rng.uniform(0.0, 0.5, w.shape).astype(
        np.float32)).to(cuda)
    a = torch.from_numpy(rng.integers(0, k, w.shape).astype(np.int32)).to(
        cuda)
    got = ops.swap_g_lanes_stats(x, y, d1, d2, a, w, k, lg, rows=rows,
                                 metric="l2", run=run)
    for i, n in enumerate(ROWS):
        if not run[i]:
            continue
        one = ops.swap_g_stats(x[i, :n].contiguous(), y[i], d1[i], d2[i],
                               a[i], w[i], k, lg[i], metric="l2")
        for g, o in zip(got, one):
            assert torch.equal(g[i, :, :n], o), (k, b, i)


@pytest.mark.parametrize("k", [5, 10, 65])
def test_top2_lanes_equal_single_launches(cuda, k):
    x, _, _, _, rows, _, rng = _lanes(cuda, seed=k)
    med = torch.stack([x[i, torch.from_numpy(
        rng.choice(n, k, replace=False)).to(cuda)]
        for i, n in enumerate(ROWS)]).contiguous()
    got = ops.stream_top2_lanes(x, med, rows=rows, metric="l2")
    for i, n in enumerate(ROWS):
        one = ops.stream_top2(x[i, :n].contiguous(), med[i].contiguous(),
                              metric="l2")
        for g, o in zip(got, one):
            assert torch.equal(g[i, :n], o), (k, i)


def _same_bits(got, want, tag):
    assert got.medoids.tolist() == want.medoids.tolist(), tag
    assert got.loss == want.loss, tag
    assert got.swap_history == want.swap_history, tag
    assert got.build_rounds == want.build_rounds, tag
    assert got.evals_by_phase == want.evals_by_phase, tag
    assert got.converged == want.converged, tag


@pytest.mark.parametrize("reuse,baseline", [("none", "none"),
                                            ("none", "leader"),
                                            ("pic", "leader")])
def test_fit_batch_equals_loop_on_card(cuda, reuse, baseline):
    ns = [900, 1337, 512, 1100]
    Xs = [datasets.mnist_like(n, seed=50 + i) for i, n in enumerate(ns)]
    seeds = [3, 4, 5, 6]
    kw = dict(metric="l2", reuse=reuse, baseline=baseline, backend="cuda")
    ops.reset_launch_counts()
    batch = BanditPAM(4, **kw).fit_batch(Xs, seeds=seeds)
    counts = ops.launch_counts()
    if reuse == "none":
        assert counts["build_g_lanes"] == batch.dispatches_by_phase["build"]
        assert counts["swap_g_lanes"] == batch.dispatches_by_phase["swap"]
        assert counts["build_g"] == counts["swap_g"] == 0
        assert counts["top2_lanes"] > 0 and counts["top2"] == 0
    else:
        assert counts["pairwise_lanes"] > 0
        assert counts["swap_g_from_cache_lanes"] > 0
        assert counts["swap_g_from_cache"] == counts["pairwise"] == 0
    for i, (X, s) in enumerate(zip(Xs, seeds)):
        _same_bits(batch[i], BanditPAM(4, seed=s, **kw).fit(X),
                   f"fit {i} ({reuse}/{baseline})")


def test_identical_lanes_launch_and_read_like_one_fit(cuda):
    X = datasets.mnist_like(2000, seed=8)
    ops.reset_launch_counts()
    single = BanditPAM(5, seed=1, backend="cuda").fit(X)
    one = ops.launch_counts()
    ops.reset_launch_counts()
    batch = BanditPAM(5, backend="cuda").fit_batch([X] * 6, seeds=[1] * 6)
    lanes = ops.launch_counts()
    assert batch.host_reads_by_phase == single.host_reads_by_phase
    assert lanes["build_g_lanes"] == one["build_g"]
    assert lanes["swap_g_lanes"] == one["swap_g"]
    for r in batch:
        _same_bits(r, single, "identical lane")


@pytest.mark.parametrize("baseline", ["none", "leader"])
def test_fit_batch_cuda_matches_torch_on_card(cuda, baseline):
    """Medoids, swaps, build rounds and labels equal.  The kernels and the
    plain versions round their batch sums differently (the l2 distances
    of integer points are square roots), which can move a kill on an
    exact margin by a round: without the leader the ledger is held
    within 10 arm-rounds, 10·B, as chip_smoke.py phase 4 holds its
    ``code_blobs`` fit.  With it, the leader's cross sums are added in
    different orders too, and on blobs whose duplicate rows tie with the
    leader that moves differenced kills: within 0.1 %, the allowance of
    tests/test_torch_cuda.py's cuda-against-torch fits."""
    ns = [1500, 1901, 1203, 1650]
    Xs = [datasets.code_blobs(n, 10, seed=i) for i, n in enumerate(ns)]
    reps = {be: KMedoids(10, solver="banditpam", metric="l2", seed=0,
                         backend=be, baseline=baseline).fit_batch(
                             Xs, seeds=[0, 1, 2, 3])
            for be in ("cuda", "torch")}
    for i in range(len(ns)):
        a, b = reps["cuda"][i], reps["torch"][i]
        assert a.medoids.tolist() == b.medoids.tolist(), i
        assert [h[:2] for h in a.swap_history] == \
            [h[:2] for h in b.swap_history], i
        assert a.build_rounds == b.build_rounds
        for p, v in b.evals_by_phase.items():
            slack = 1e-3 * v if baseline == "leader" else 10 * B
            assert abs(a.evals_by_phase[p] - v) <= slack, (i, p)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
    np.testing.assert_array_equal(reps["cuda"].labels, reps["torch"].labels)


# ---------------------------------------------------------------------------
# The PIC batch
# ---------------------------------------------------------------------------

RING_ROUNDS = 4


def _ring(dev, x, rows, seed=0):
    """A lane ring [L, n_pad, (W+1)·B] whose slots hold distances of
    their own batches, written by single launches."""
    gen = torch.Generator().manual_seed(seed)
    L, n_pad, _ = x.shape
    store = torch.zeros((L, n_pad, (RING_ROUNDS + 1) * B), device=dev)
    for r in range(RING_ROUNDS + 1):
        for i, n in enumerate(ROWS):
            ref = torch.randint(0, n, (B,), generator=gen).to(dev)
            store[i, :n, r * B:(r + 1) * B] = ops.pairwise_distance(
                x[i, :n].contiguous(), x[i, ref].contiguous(), "l2")
    return store


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_pairwise_lanes_equal_single_launches(cuda, metric):
    x, y, _, _, rows, run, _ = _lanes(cuda)
    store = torch.full((len(ROWS), x.shape[1], (RING_ROUNDS + 1) * B), 3.0,
                       device=cuda)
    col = torch.tensor([2 * B, RING_ROUNDS * B, 0, B], dtype=torch.int64,
                       device=cuda)
    ops.pairwise_lanes(x, y, metric, out=store, col=col, xrows=rows, run=run)
    picks = torch.tensor([[5], [0], [77], [511]], device=cuda)
    xp = torch.stack([x[i, picks[i]] for i in range(len(ROWS))]).contiguous()
    dn = ops.pairwise_lanes(xp, x, metric, yrows=rows)
    for i, n in enumerate(ROWS):
        c = int(col[i])
        blk = store[i, :n, c:c + B]
        if run[i]:
            assert torch.equal(blk, ops.pairwise_distance(
                x[i, :n].contiguous(), y[i], metric)), (metric, i)
        else:
            assert torch.equal(blk, torch.full_like(blk, 3.0)), (metric, i)
        others = torch.cat([store[i, :n, :c], store[i, :n, c + B:]], dim=1)
        assert torch.equal(others, torch.full_like(others, 3.0))
        assert torch.equal(dn[i, 0, :n], ops.pairwise_distance(
            xp[i], x[i, :n].contiguous(), metric)[0]), (metric, i)


@pytest.mark.parametrize("k", [3, 10, 65])
def test_swap_g_from_cache_lanes_equal_single_launches(cuda, k):
    """At a round's block (each lane's own column: a slot or the scratch)
    and at the repair's shape (each lane's whole ring, sparse weights)."""
    x, _, _, lg, rows, run, rng = _lanes(cuda, seed=k)
    store = _ring(cuda, x, rows, seed=k)
    L = len(ROWS)

    def vectors(b, share):
        d1 = torch.from_numpy(rng.uniform(0.1, 0.6, (L, b)).astype(
            np.float32)).to(cuda)
        d2 = d1 + torch.from_numpy(rng.uniform(0.0, 0.5, (L, b)).astype(
            np.float32)).to(cuda)
        a = torch.from_numpy(rng.integers(0, k, (L, b)).astype(
            np.int32)).to(cuda)
        w = torch.from_numpy((rng.uniform(size=(L, b)) < share).astype(
            np.float32)).to(cuda)
        return d1, d2, a, w

    col = torch.tensor([2 * B, RING_ROUNDS * B, 0, B], dtype=torch.int64,
                       device=cuda)
    for b, c, share, lead in ((B, col, 0.95, lg),
                              (RING_ROUNDS * B, None, 0.05, None)):
        d1, d2, a, w = vectors(b, share)
        got = ops.swap_g_from_cache_lanes_stats(store, d1, d2, a, w, k, lead,
                                                col=c, rows=rows, run=run)
        for i, n in enumerate(ROWS):
            if not run[i]:
                continue
            c0 = 0 if c is None else int(c[i])
            one = ops.swap_g_stats_cached(
                store[i, :n, c0:c0 + b], d1[i], d2[i], a[i], w[i], k,
                None if lead is None else lead[i])
            for g, o in zip(got, one):
                assert torch.equal(g[i, :, :n], o), (k, b, i)


@pytest.mark.parametrize("leader", [False, True])
def test_served_build_stats_lanes_equal_single_calls(cuda, leader):
    """The served BUILD statistics are the plain math with a lane axis
    (row sums over [L, n_pad, B]); each lane gets the single [n, B]
    call's bits, at a slot and with a lane in the scratch."""
    x, _, w, _, rows, _, rng = _lanes(cuda)
    store = _ring(cuda, x, rows)
    lanes = engine.LaneData(data=x, ns=list(ROWS), rows=rows,
                            base=torch.arange(len(ROWS), device=cuda)
                            * x.shape[1])
    dn = torch.from_numpy(rng.uniform(0.2, 1.0, w.shape).astype(
        np.float32)).to(cuda)
    dn[:, :11] = float("inf")
    lead = (torch.tensor([3, 0, 100, 17], device=cuda) if leader else None)
    be = engine.get_stats_backend("cuda")
    for cols in ([2 * B] * 4, [2 * B, RING_ROUNDS * B, 0, B]):
        col = torch.tensor(cols, dtype=torch.int64, device=cuda)
        blocks = engine.LaneBlocks(store, cols, col, B)
        got = be.build_stats_from_d_lanes(lanes, blocks, dn, w, lead)
        for i, n in enumerate(ROWS):
            one = be.build_stats_from_d(blocks.lane(i, n), dn[i], w[i],
                                        None if lead is None else lead[i])
            for g, o in zip(got, one):
                assert torch.equal(g[i, :n], o), (cols, i)


@pytest.mark.parametrize("baseline", ["none", "leader"])
def test_pic_fit_batch_with_recycling_and_carrying_lanes_equals_loop(
        cuda, baseline):
    """A ring of 10 rounds: the lanes of 512 and 900 points carry their
    SWAP moments, those of 1,100 and 1,337 recycle and start cold."""
    ns = [900, 1337, 512, 1100]
    Xs = [datasets.mnist_like(n, seed=70 + i) for i, n in enumerate(ns)]
    seeds = [3, 4, 5, 6]
    kw = dict(metric="l2", reuse="pic", cache_width=1000, baseline=baseline,
              backend="cuda")
    ops.reset_launch_counts()
    batch = BanditPAM(4, **kw).fit_batch(Xs, seeds=seeds)
    counts = ops.launch_counts()
    assert counts["pairwise_lanes"] > 0
    assert counts["swap_g_from_cache_lanes"] > 0
    assert counts["pairwise"] == counts["swap_g_from_cache"] == 0
    for i, (X, s) in enumerate(zip(Xs, seeds)):
        _same_bits(batch[i], BanditPAM(4, seed=s, **kw).fit(X),
                   f"fit {i} (pic/{baseline})")


def test_identical_pic_lanes_launch_and_read_like_one_fit(cuda, monkeypatch):
    X = datasets.mnist_like(2000, seed=8)
    kw = dict(reuse="pic", cache_width=1000, backend="cuda")
    calls = {"all": 0, "build": 0}

    def spy(orig, key):
        def counted(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)
        return counted
    # One ring access a round; the BUILD rounds' statistics calls.
    monkeypatch.setattr(banditpam, "search_read_or_write",
                        spy(banditpam.search_read_or_write, "all"))
    monkeypatch.setattr(engine.CudaStatsBackend, "build_stats_from_d",
                        spy(engine.CudaStatsBackend.build_stats_from_d,
                            "build"))
    ops.reset_launch_counts()
    single = BanditPAM(5, seed=1, **kw).fit(X)
    one = ops.launch_counts()
    monkeypatch.undo()
    ops.reset_launch_counts()
    batch = BanditPAM(5, **kw).fit_batch([X] * 6, seeds=[1] * 6)
    lanes = ops.launch_counts()
    assert batch.host_reads_by_phase == single.host_reads_by_phase
    assert batch.dispatches_by_phase == {
        "build": calls["build"], "swap": calls["all"] - calls["build"]}
    assert lanes["swap_g_from_cache_lanes"] == one["swap_g_from_cache"]
    assert lanes["pairwise_lanes"] == one["pairwise"]
    for r in batch:
        _same_bits(r, single, "identical lane")
