"""The port's CUDA kernels against their plain versions, and the
``cuda`` stats backend against ``torch``, on the card.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device (decided inside the fixture, never at import).  Run on the
card with ``python -m pytest -m gpu tests/test_torch_*.py``.

Tolerance: kernel and plain version sum their dot products and
abs-sums in different orders; over d features the relative error of
such a sum is at most d·2^-24, so distances may differ by
``dtol = d·2^-24·max|d|`` (and by sqrt of that scale near 0 for l2) and
the B-term statistics by B times that (times max|d| for the squared and
cross sums).  The streaming kernels sum r terms, so r takes B's place.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BanditPAM, datasets, pam, rng
from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g

pytestmark = pytest.mark.gpu

METRICS = ["l2", "l2sq", "l1", "cosine"]
B = 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(n, d, seed, dev):
    return torch.from_numpy(datasets.mnist_like(n, seed=seed, d=d)).to(dev)


def _dtol(metric, dmax, d):
    e = d * 2.0 ** -24
    return (np.sqrt(e) if metric == "l2" else e) * dmax


def _close(got, want, atol, rtol=1e-5):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m,r,d", [(1000, 10, 784), (130, 300, 33),
                                   (7, 65, 12), (1, 60000, 784),
                                   (1, 100, 784), (60000, 100, 784),
                                   (5, 3, 784)])
def test_pairwise_kernel_matches_plain(cuda, metric, m, r, d):
    x, y = _x(m + r, d, 0, cuda).split([m, r])
    x, y = x.contiguous(), y.contiguous()
    before = pairwise.launches
    got = ops.pairwise_distance(x, y, metric)
    torch.cuda.synchronize()
    assert pairwise.launches == before + 1
    want = pairwise.pairwise_torch(x, y, metric=metric)
    _close(got, want, _dtol(metric, float(want.abs().max()), d))


@pytest.mark.parametrize("metric", METRICS)
def test_build_g_kernel_matches_plain(cuda, metric):
    n, d = 1300, 64
    x = _x(n, d, 1, cuda)
    g = torch.Generator().manual_seed(0)
    y = x[torch.randperm(n, generator=g)[:B].to(cuda)].contiguous()
    dmax = float(pairwise.pairwise_torch(x, y, metric=metric).max())
    dn = torch.rand(B, generator=g).to(cuda) * dmax
    dn[::7] = float("inf")
    w = torch.ones(B, device=cuda)
    w[::9] = 0.0
    lg = torch.randn(B, generator=g).to(cuda)
    got = ops.build_g_stats(x, y, dn, w, lg, metric=metric)
    want = build_g.build_g_torch(x, y, dn, w, lg, metric)
    tol = _dtol(metric, dmax, d)
    lgm = float(lg.abs().max())
    for a, b, at in zip(got, want, (B * tol, 2 * B * dmax * tol,
                                    B * lgm * tol)):
        _close(a, b, at)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [100, 37, 300])
@pytest.mark.parametrize("d", [784, 33, 12])
def test_build_g_equals_stream_build_g_bits(cuda, metric, b, d):
    """build_g and stream_build_g at r = B <= 512 fold the same distance
    bits in the same order (four residue partials per row, one 512-column
    reference tile), so their sums are equal bit for bit; B = 300 walks
    several of build_g's column tiles, m = 1300 leaves a ragged row
    tile."""
    n = 1300
    x = _x(n, d, 20, cuda)
    g = torch.Generator().manual_seed(b + d)
    y = x[torch.randperm(n, generator=g)[:b].to(cuda)].contiguous()
    w = torch.ones(b, device=cuda)
    w[::9] = 0.0
    lg = torch.randn(b, generator=g).to(cuda)
    dmax = float(pairwise.pairwise_torch(x, y, metric=metric).max())
    for dn in (torch.full((b,), float("inf"), device=cuda),
               torch.rand(b, generator=g).to(cuda) * dmax):
        got = ops.build_g_stats(x, y, dn, w, lg, metric=metric)
        want = ops.stream_build_g_stats(x, y, dn, w, lg, metric=metric)
        for a, c in zip(got, want):
            assert torch.equal(a, c)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [10, 40, 65, 200])
def test_pairwise_row_minima_equal_top2_bits(cuda, metric, k):
    """The pairwise kernel and the top-2 kernel run the same mainloop
    chains (dist_math.cuh) in different tile shapes, so each distance has
    the same bits and a row's two smallest pairwise entries are top-2's
    d1 and d2 (k = 10, 40, 65, 200 cover top-2's four tiles)."""
    x = _x(3000, 784, 21, cuda)
    step = min(71, 3000 // k)
    med = x[torch.arange(0, step * k, step, device=cuda)].contiguous()
    dd = ops.pairwise_distance(x, med, metric)
    two = torch.topk(dd, 2, dim=1, largest=False).values
    d1, d2, _ = ops.stream_top2(x, med, metric=metric)
    assert torch.equal(two[:, 0].contiguous(), d1)
    assert torch.equal(two[:, 1].contiguous(), d2)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 3, 10])
def test_swap_g_kernel_matches_plain(cuda, metric, k):
    n, d = 1300, 64
    x = _x(n, d, 2, cuda)
    g = torch.Generator().manual_seed(k)
    y = x[torch.randperm(n, generator=g)[:B].to(cuda)].contiguous()
    med = x[torch.randperm(n, generator=g)[:k].to(cuda)].contiguous()
    d1, d2, a = stream_g.top2_torch(y, med, metric)
    d2 = torch.where(torch.isinf(d2), d1 * 2, d2)
    w = torch.ones(B, device=cuda)
    w[-13:] = 0.0
    lg = torch.randn(B, generator=g).to(cuda)
    got = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
    want = swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg, metric)
    dmax = float(pairwise.pairwise_torch(x, y, metric=metric).max())
    tol = _dtol(metric, dmax, d)
    lgm = float(lg.abs().max())
    for a_, b_, at in zip(got, want, (2 * B * tol, 4 * B * dmax * tol,
                                      2 * B * lgm * tol)):
        assert a_.shape == (k, n)
        _close(a_, b_, at)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [100, 37, 300])
@pytest.mark.parametrize("d", [784, 33, 12])
@pytest.mark.parametrize("k", [1, 10, 64, 65, 200])
def test_swap_g_equals_stream_swap_g_bits(cuda, metric, b, d, k):
    """swap_g and stream_swap_g at r = B <= 512 are one kernel walking
    one reference tile, and fold the same distance bits in the same
    order: per row, four residue owners, each over its columns in
    increasing order, then 0 + 1 + 2 + 3, at every k (past 32 clusters
    the bins are held a chunk of 32 at a time).  B = 37 and 100 are one
    column tile of the mainloop, B = 300 three, whose bins cross column
    tiles through the scratch; m = 1300 leaves a ragged row tile."""
    n = 1300
    x = _x(n, d, 22, cuda)
    g = torch.Generator().manual_seed(1000 * k + b + d)
    y = x[torch.randperm(n, generator=g)[:b].to(cuda)].contiguous()
    med = x[torch.randperm(n, generator=g)[:k].to(cuda)].contiguous()
    d1, d2, a = ops.stream_top2(y, med, metric=metric)
    w = torch.ones(b, device=cuda)
    w[::9] = 0.0
    lg = torch.randn(b, generator=g).to(cuda)
    got = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
    want = ops.stream_swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
    for a_, c in zip(got, want):
        assert a_.shape == (k, n)
        assert torch.equal(a_, c)


@pytest.mark.parametrize("b", [1, 104, 105, 300, 700])
def test_swap_g_shape_rules(cuda, b):
    """Every batch width runs the one mainloop kernel as a single
    reference tile: one column tile up to B = 104 (the fits' B = 100),
    several past it, with no reset at 512 (B = 700: stream_swap_g would
    reset there, so the two differ only in summation order)."""
    n, d, k = 1300, 48, 10
    x = _x(n, d, 25, cuda)
    g = torch.Generator().manual_seed(b)
    y = x[torch.randint(0, n, (b,), generator=g).to(cuda)].contiguous()
    med = x[torch.randperm(n, generator=g)[:k].to(cuda)].contiguous()
    d1, d2, a = ops.stream_top2(y, med, metric="l2")
    w = torch.ones(b, device=cuda)
    w[::9] = 0.0
    lg = torch.randn(b, generator=g).to(cuda)
    before = swap_g.launches
    got = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric="l2")
    torch.cuda.synchronize()
    assert swap_g.launches == before + 1
    want = swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg, "l2")
    dmax = float(pairwise.pairwise_torch(x, y, metric="l2").max())
    tol = _dtol("l2", dmax, d)
    lgm = float(lg.abs().max())
    for a_, b_, at in zip(got, want, (2 * b * tol, 4 * b * dmax * tol,
                                      2 * b * lgm * tol)):
        _close(a_, b_, at)
    if b <= 512:
        stream = ops.stream_swap_g_stats(x, y, d1, d2, a, w, k, lg,
                                         metric="l2")
        assert all(torch.equal(a_, c) for a_, c in zip(got, stream))


def test_swap_g_empty_batch_gives_zeros(cuda):
    """No reference column: every statistic is an empty sum, 0."""
    x = _x(300, 16, 24, cuda)
    z = torch.zeros(0, device=cuda)
    out = ops.swap_g_stats(x, x[:0].contiguous(), z, z,
                           torch.zeros(0, dtype=torch.int32, device=cuda),
                           z, 10, z)
    for t in out:
        assert torch.equal(t, torch.zeros((10, 300), device=cuda))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [784, 33])
def test_stream_build_g_walk_order_bits(cuda, metric, d):
    """At r = 1300 the streaming kernel sums three reference tiles, each
    folded as build_g folds a batch, in walk order from 0:
    ((0 + T[0:512]) + T[512:1024]) + T[1024:1300], float32 adds."""
    x, y, w, lg, g = _stream_inputs(cuda, 23, n=1300, r=1300, d=d)
    r = y.shape[0]
    dmax = float(pairwise.pairwise_torch(x, y, metric=metric).max())
    for dn in (torch.full((r,), float("inf"), device=cuda),
               torch.rand(r, generator=g).to(cuda) * dmax):
        want = [torch.zeros(x.shape[0], device=cuda) for _ in range(3)]
        for lo in (0, 512, 1024):
            sl = slice(lo, min(lo + 512, r))
            part = ops.build_g_stats(x, y[sl].contiguous(), dn[sl].contiguous(),
                                     w[sl].contiguous(), lg[sl].contiguous(),
                                     metric=metric)
            want = [a + p for a, p in zip(want, part)]
        got = ops.stream_build_g_stats(x, y, dn, w, lg, metric=metric)
        for a, c in zip(got, want):
            assert torch.equal(a, c)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_swap_g_kernel_past_64_medoids_matches_plain(cuda, metric):
    """k = 65: the bins of 65 clusters are held in chunks of 32, 32 and
    1; every arm matches the plain version."""
    test_swap_g_kernel_matches_plain(cuda, metric, 65)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 5, 17, 40, 65, 200])
@pytest.mark.parametrize("d", [48, 47])
def test_top2_kernel_matches_plain(cuda, metric, k, d):
    """Every top-2 tile (16, 40, 72 and 104 columns at k = 1 and 5, 17
    and 40, 65, 200) and several column tiles (k = 200); d = 47 takes the
    4-byte copies."""
    n = max(2000, 17 * k)
    x = _x(n, d, 4, cuda)
    med = x[torch.arange(0, 17 * k, 17, device=cuda)].contiguous()
    if k > 1:
        med[-1] = med[0]                     # duplicate rows: d2 == d1
    got = ops.stream_top2(x, med, metric=metric)
    want = stream_g.top2_torch(x, med, metric)
    # The error scale is max|d| (module docstring).  With few medoids the
    # largest d1 stands in for it; past 17 the largest d1 shrinks (at
    # k = 200 it is far below the norms and the cosine similarities that
    # set the float32 noise), so those cases take max|d| of the block.
    dmax = float(want[0].max() if k <= 17 else
                 pairwise.pairwise_torch(x, med, metric=metric).max())
    tol = _dtol(metric, dmax, d)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    clear = (want[1] - want[0]) > 2 * tol
    assert torch.equal(got[2][clear], want[2][clear])
    if k > 1:
        on0 = got[2] == 0
        assert torch.equal(got[1][on0], got[0][on0])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k,dups", [(200, (5, 16, 103, 104, 150)),
                                    (65, (4, 5, 16, 64)),
                                    (40, (5, 16, 39)),
                                    (16, (4, 5, 15))])
def test_top2_duplicate_medoids_first_index_bits(cuda, metric, k, dups):
    """Copies of medoid 0 where the merge is tested, one tile shape each:
    in one thread's own columns (16, and 64 at k = 65; 4 at k = 16),
    across the threads of a row (5, 15, 39), and across the 104-column
    tiles of k = 200 (103 | 104, 150).  assign is the first index attaining d1,
    bit for bit pairwise's first argmin, and d2 == d1 where it is 0."""
    n, d = 3000, 96
    x = _x(n, d, 23, cuda)
    step = n // k
    med = x[torch.arange(0, step * k, step, device=cuda)].contiguous()
    for j in dups:
        med[j] = med[0]
    d1, d2, a = ops.stream_top2(x, med, metric=metric)
    dd = ops.pairwise_distance(x, med, metric)
    assert torch.equal(d1, dd.min(dim=1).values)
    assert torch.equal(a, torch.argmin(dd, dim=1).to(torch.int32))
    on0 = a == 0
    assert bool(on0.any())
    assert torch.equal(d2[on0], d1[on0])
    for j in dups:
        assert not bool((a == j).any())


def test_cuda_tensor_never_falls_back(cuda):
    x = _x(50, 16, 5, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.pairwise_distance(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.pairwise_distance(x, x.cpu())


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_cuda_fit_matches_torch_fit_on_card(cuda, metric):
    """Same permutations, kernels vs plain versions on the card.

    The fits must pick the same medoids through the same swaps.  The
    ledgers may differ by single arm-rounds: the kill rule compares
    confidence bounds in float32, and the kernels' distances differ from
    cuBLAS's in the last bits, so an arm on an exact margin can survive
    one round longer (seen at n=1500, l2: BUILD 2459700 vs 2459800
    evaluations).  Hence the 0.1 % ledger tolerance here; chip_smoke.py
    holds the ledgers exactly equal at its own fixture.
    """
    n, k = 1500, 4
    X = datasets.mnist_like(n, seed=6)
    p = np.random.default_rng(0)
    perms = (np.stack([p.permutation(n) for _ in range(k)]),
             np.stack([p.permutation(n) for _ in range(4 * k + 10)]))
    ops.reset_launch_counts()
    a = BanditPAM(k, metric=metric, backend="cuda", device=cuda).fit(
        X, layouts=rng.from_numpy(*perms))
    counts = ops.launch_counts()
    b = BanditPAM(k, metric=metric, backend="torch", device=cuda).fit(
        X, layouts=rng.from_numpy(*perms))
    assert counts["build_g"] > 0 and counts["swap_g"] > 0
    assert counts["top2"] > 0
    assert counts["pairwise"] == k           # one d_near update per pick
    assert a.medoids.tolist() == b.medoids.tolist()
    assert [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
    assert (a.n_swaps, a.converged) == (b.n_swaps, b.converged)
    assert a.evals_by_phase.keys() == b.evals_by_phase.keys()
    for ph, v in b.evals_by_phase.items():
        assert abs(a.evals_by_phase[ph] - v) <= 1e-3 * v, ph
    assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)


def _stream_inputs(cuda, seed, n=1300, r=1100, d=64):
    """x [n, d] and a reference set y [r, d] (r not a multiple of 512),
    weight-0 slots and a non-zero leader row."""
    x = _x(n, d, seed, cuda)
    g = torch.Generator().manual_seed(seed)
    y = x[torch.randperm(n, generator=g)[:r].to(cuda)].contiguous()
    w = torch.ones(r, device=cuda)
    w[::13] = 0.0
    lg = torch.randn(r, generator=g).to(cuda)
    return x, y, w, lg, g


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dnear_kind", ["finite", "inf"])
def test_stream_build_g_kernel_matches_plain(cuda, metric, dnear_kind):
    x, y, w, lg, g = _stream_inputs(cuda, 7)
    r, d = y.shape
    dmax = float(pairwise.pairwise_torch(x, y, metric=metric).max())
    dn = torch.rand(r, generator=g).to(cuda) * dmax
    if dnear_kind == "inf":
        dn[:] = float("inf")
    before = stream_g.stream_build_launches
    got = ops.stream_build_g_stats(x, y, dn, w, lg, metric=metric)
    torch.cuda.synchronize()
    assert stream_g.stream_build_launches == before + 1
    want = stream_g.stream_build_g_torch(x, y, dn, w, lg, metric)
    tol = _dtol(metric, dmax, d)
    lgm = float(lg.abs().max())
    for a, b, at in zip(got, want, (r * tol, 2 * r * dmax * tol,
                                    r * lgm * tol)):
        _close(a, b, at)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 3, 10])
def test_stream_swap_g_kernel_matches_plain(cuda, metric, k):
    x, y, w, lg, g = _stream_inputs(cuda, 8 + k)
    r, d = y.shape
    med = x[torch.randperm(x.shape[0], generator=g)[:k].to(cuda)].contiguous()
    d1, d2, a = stream_g.top2_torch(y, med, metric)
    d2 = torch.where(torch.isinf(d2), d1 * 2, d2)
    before = stream_g.stream_swap_launches
    got = ops.stream_swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
    torch.cuda.synchronize()
    assert stream_g.stream_swap_launches == before + 1
    want = stream_g.stream_swap_g_torch(x, y, d1, d2, a, w, k, lg, metric)
    dmax = float(pairwise.pairwise_torch(x, y, metric=metric).max())
    tol = _dtol(metric, dmax, d)
    lgm = float(lg.abs().max())
    for a_, b_, at in zip(got, want, (2 * r * tol, 4 * r * dmax * tol,
                                      2 * r * lgm * tol)):
        assert a_.shape == (k, x.shape[0])
        _close(a_, b_, at)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_stream_swap_g_kernel_past_64_medoids_matches_plain(cuda, metric):
    """k = 65 over r = 1100 references (three reference tiles, their
    bins crossing column tiles through the scratch, in three chunks)."""
    test_stream_swap_g_kernel_matches_plain(cuda, metric, 65)


def _same_fit(a, b, ledger_rtol=0.0, loss_atol=0.0):
    assert a.medoids.tolist() == b.medoids.tolist()
    assert [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
    assert (a.n_swaps, a.converged) == (b.n_swaps, b.converged)
    assert a.swap_exact_fallbacks == b.swap_exact_fallbacks
    assert a.evals_by_phase.keys() == b.evals_by_phase.keys()
    for ph, v in b.evals_by_phase.items():
        assert abs(a.evals_by_phase[ph] - v) <= ledger_rtol * v, ph
    assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss) + loss_atol


def _self_distance_noise(X, medoids):
    """Limit on the two backends' l2 loss difference from the medoids'
    distances to themselves: each is the square root of the l2sq
    cancellation noise, at most sqrt(2·d·2^-24)·|x| for medoid row x,
    which the kernels and cuBLAS round differently (ROADMAP, "l2
    distances near 0").  It grows with k."""
    d = X.shape[1]
    norms = np.linalg.norm(X[np.asarray(medoids)].astype(np.float64), axis=1)
    return float(np.sqrt(2 * d * 2.0 ** -24) * norms.sum())


def test_cuda_fit_matches_torch_fit_replacement_leader(cuda):
    """Replacement sampling with the leader baseline, the same draws,
    kernels vs plain versions on the card.  The exact fallbacks run the
    streaming kernels.  The ledger tolerance is the one of
    ``test_cuda_fit_matches_torch_fit_on_card`` (single arm-rounds on an
    exact float32 margin)."""
    n, k, b = 1500, 4, 100
    X = datasets.mnist_like(n, seed=6)
    p = np.random.default_rng(1)
    r = -(-n // b)
    draws = (p.integers(0, n, (k, r, b)),
             p.integers(0, n, (4 * k + 10, r, b)))
    kw = dict(sampling="replacement", baseline="leader")
    ops.reset_launch_counts()
    a = BanditPAM(k, backend="cuda", device=cuda, **kw).fit(
        X, layouts=rng.from_numpy(build_draws=draws[0], swap_draws=draws[1]))
    counts = ops.launch_counts()
    b_ = BanditPAM(k, backend="torch", device=cuda, **kw).fit(
        X, layouts=rng.from_numpy(build_draws=draws[0], swap_draws=draws[1]))
    assert counts["stream_build_g"] >= 1 and counts["stream_swap_g"] >= 1
    assert counts["build_g"] > 0 and counts["swap_g"] > 0
    assert counts["pairwise"] > k            # d_near updates + leader rows
    assert a.build_rounds == b_.build_rounds
    _same_fit(a, b_, ledger_rtol=1e-3)


def test_pam_cuda_matches_torch_on_card(cuda):
    n, k = 1500, 4
    X = datasets.mnist_like(n, seed=7)
    ops.reset_launch_counts()
    a = pam(X, k, backend="cuda", device=cuda)
    counts = ops.launch_counts()
    b = pam(X, k, backend="torch", device=cuda)
    assert counts["stream_build_g"] == k
    assert counts["stream_swap_g"] == a.n_swaps + (1 if a.converged else 0)
    _same_fit(a, b)


def _cached_inputs(cuda, seed, m, width, b, k, w_share=1.0):
    """A ring [m, width] of l2 distances, its column slice [m, b] at an
    offset (row stride width != b), the slice's medoid-cache vectors from
    real medoids, {0,1} weights (a share ``w_share`` of them 1) and a
    leader row."""
    x = _x(m, 48, seed, cuda)
    g = torch.Generator().manual_seed(seed)
    refs = x[torch.randint(0, m, (width,), generator=g).to(cuda)].contiguous()
    ring = pairwise.pairwise_torch(x, refs, metric="l2")
    lo = width - b
    view = ring[:, lo:]
    med = x[torch.randperm(m, generator=g)[:k].to(cuda)].contiguous()
    d1, d2, a = stream_g.top2_torch(refs[lo:].contiguous(), med, "l2")
    w = (torch.rand(b, generator=g) < w_share).float().to(cuda)
    w[-7:] = 0.0
    lg = torch.randn(b, generator=g).to(cuda)
    return view, d1, d2, a, w, lg


def _cached_tol(view, d1, d2, w, lg):
    """The two versions read the same distances and differ only in
    summation order: at most 2·B·2^-24 times the sum of the terms'
    magnitudes, bounded by max|d| (base and corr each lie in [-dmax,
    dmax], d2 may be inf when k == 1)."""
    b = view.shape[1]
    dmax = float(view.max())
    lgm = float(lg.abs().max())
    e = 2 * b * 2.0 ** -24
    return e * 2 * b * dmax, e * 4 * b * dmax ** 2, e * 2 * b * dmax * lgm


@pytest.mark.parametrize("k", [1, 10, 64, 65, 200])
def test_swap_g_from_cache_kernel_matches_plain(cuda, k):
    view, d1, d2, a, w, lg = _cached_inputs(cuda, 11, 1300, 700, 300, k)
    assert view.stride(0) == 700 and not view.is_contiguous()
    before = swap_g.cached_launches
    got = ops.swap_g_stats_cached(view, d1, d2, a, w, k, lg)
    torch.cuda.synchronize()
    assert swap_g.cached_launches == before + 1
    want = swap_g.swap_g_from_cache_torch(view, d1, d2, a, w, k, lg)
    for g_, w_, at in zip(got, want, _cached_tol(view, d1, d2, w, lg)):
        assert g_.shape == (k, 1300)
        _close(g_, w_, at)


@pytest.mark.parametrize("k", [5, 65])
def test_swap_g_from_cache_kernel_at_the_repair_shape(cuda, k):
    """The carried-moment repair: the whole ring, about 5 % of the
    weights set, weighted columns in every residue mod 4, columns
    [1024, 2048) all weight 0 (a whole scan of every residue's columns
    finds none) and the last column weighted."""
    view, d1, d2, a, w, _ = _cached_inputs(cuda, 12, 1300, 2600, 2600, k,
                                           w_share=0.05)
    w[1024:2048] = 0.0
    w[100:104] = 1.0
    w[-1] = 1.0
    assert 0 < float(w.sum()) < 0.1 * 2600
    z = torch.zeros_like(d1)
    got = ops.swap_g_stats_cached(view, d1, d2, a, w, k)
    want = swap_g.swap_g_from_cache_torch(view, d1, d2, a, w, k, z)
    for g_, w_, at in zip(got, want, _cached_tol(view, d1, d2, w, z)):
        _close(g_, w_, at)
    w0 = torch.zeros_like(w)
    for t in ops.swap_g_stats_cached(view, d1, d2, a, w0, k):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("k", [1, 7, 10, 64, 65, 200])
def test_swap_g_from_cache_equals_swap_g_on_equal_distances(cuda, metric, k):
    """Both SWAP kernels share one column routine, one owner order and
    one fold, so the cached kernel fed the pairwise kernel's distances
    (the same distance bits) returns swap_g's bits at every k."""
    n, d = 1300, 64
    x = _x(n, d, 13, cuda)
    g = torch.Generator().manual_seed(13)
    y = x[torch.randperm(n, generator=g)[:B].to(cuda)].contiguous()
    med = x[torch.randperm(n, generator=g)[:k].to(cuda)].contiguous()
    d1, d2, a = ops.stream_top2(y, med, metric=metric)
    w = torch.ones(B, device=cuda)
    w[-9:] = 0.0
    lg = torch.randn(B, generator=g).to(cuda)
    fused = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
    cached = ops.swap_g_stats_cached(ops.pairwise_distance(x, y, metric),
                                     d1, d2, a, w, k, lg)
    for f, c in zip(fused, cached):
        assert torch.equal(f, c)


def test_swap_g_from_cache_kernel_past_64_medoids_matches_plain(cuda):
    """k = 65 at a round's shape (a contiguous [m, 100] block, dense
    weights): the bins are held in chunks of 32, 32 and 1, each chunk a
    walk of its own columns."""
    k = 65
    view, d1, d2, a, w, lg = _cached_inputs(cuda, 14, 1300, 100, 100, k)
    assert view.is_contiguous()
    got = ops.swap_g_stats_cached(view, d1, d2, a, w, k, lg)
    want = swap_g.swap_g_from_cache_torch(view, d1, d2, a, w, k, lg)
    for g_, w_, at in zip(got, want, _cached_tol(view, d1, d2, w, lg)):
        assert g_.shape == (k, 1300)
        _close(g_, w_, at)


@pytest.mark.parametrize("kw", [{"reuse": "pic"},
                                {"reuse": "pic", "cache_width": 500},
                                {"reuse": "none", "cache_cols": 700}])
def test_cuda_cached_fit_matches_torch_fit_on_card(cuda, kw):
    """The cache regimes, the same fixed permutation, kernels vs plain
    versions on the card; the ledger tolerance of
    ``test_cuda_fit_matches_torch_fit_on_card`` (single arm-rounds on an
    exact float32 margin)."""
    n, k = 1500, 4
    X = datasets.mnist_like(n, seed=6)
    perm = np.random.default_rng(2).permutation(n)
    ops.reset_launch_counts()
    a = BanditPAM(k, backend="cuda", device=cuda, **kw).fit(
        X, layouts=rng.from_numpy(fixed_perm=perm))
    counts = ops.launch_counts()
    b_ = BanditPAM(k, backend="torch", device=cuda, **kw).fit(
        X, layouts=rng.from_numpy(fixed_perm=perm))
    assert counts["swap_g_from_cache"] > 0
    assert counts["pairwise"] > k
    if kw["reuse"] == "pic":
        assert a.evals_by_phase["swap_cached"] > 0
    assert a.build_rounds == b_.build_rounds
    _same_fit(a, b_, ledger_rtol=1e-3)


@pytest.mark.parametrize("solver", ["banditpam", "pam"])
def test_cuda_fit_past_64_medoids_matches_torch_on_card(cuda, solver):
    """k = 65 fits on the card through every SWAP kernel (none refuses a
    k) and agrees with the plain versions.  On real-valued data some of
    a k = 65 fit's many decisions sit on a float32 margin that the
    kernels and cuBLAS round differently (mnist_like, n = 1500: PAM's
    24th medoid differs); the integer blobs of ``datasets.code_blobs``
    give both backends the same distances, so the fits agree, the
    ledger within the tolerance of
    ``test_cuda_fit_matches_torch_fit_on_card``."""
    n, k = 1300, 65
    X = datasets.code_blobs(n, k, seed=4)
    ops.reset_launch_counts()
    if solver == "pam":
        a = pam(X, k, backend="cuda", device=cuda)
        counts = ops.launch_counts()
        b_ = pam(X, k, backend="torch", device=cuda)
        assert counts["stream_swap_g"] >= 1
        _same_fit(a, b_, loss_atol=_self_distance_noise(X, b_.medoids))
        return
    p = np.random.default_rng(3)
    perms = (np.stack([p.permutation(n) for _ in range(k)]),
             np.stack([p.permutation(n) for _ in range(4 * k + 10)]))
    a = BanditPAM(k, backend="cuda", device=cuda).fit(
        X, layouts=rng.from_numpy(*perms))
    counts = ops.launch_counts()
    b_ = BanditPAM(k, backend="torch", device=cuda).fit(
        X, layouts=rng.from_numpy(*perms))
    assert counts["swap_g"] > 0 and a.n_swaps > 0
    assert a.build_rounds == b_.build_rounds
    _same_fit(a, b_, ledger_rtol=1e-3,
              loss_atol=_self_distance_noise(X, b_.medoids))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kernel", ["build_g", "swap_g"])
@pytest.mark.parametrize("b", [100, 300])
def test_round_kernels_run_flag(cuda, metric, kernel, b):
    """The run flag of the round kernels: at 1 the outputs equal the bits
    of no flag (NULL); at 0 every block returns at once, the launch still
    counts, and the stream goes on (a later call gives the same bits
    again).  B = 300 takes swap_g's scratch path."""
    n, d, k = 1300, 64, 10
    x = _x(n, d, 30, cuda)
    g = torch.Generator().manual_seed(b)
    y = x[torch.randperm(n, generator=g)[:b].to(cuda)].contiguous()
    w = torch.ones(b, device=cuda)
    w[::9] = 0.0
    lg = torch.randn(b, generator=g).to(cuda)
    if kernel == "build_g":
        mod = build_g
        dn = torch.rand(b, generator=g).to(cuda)
        dn[::7] = float("inf")

        def call(run):
            return ops.build_g_stats(x, y, dn, w, lg, metric=metric, run=run)
    else:
        mod = swap_g
        med = x[torch.randperm(n, generator=g)[:k].to(cuda)].contiguous()
        d1, d2, a = ops.stream_top2(y, med, metric=metric)

        def call(run):
            return ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric,
                                    run=run)
    flag = {v: torch.tensor([v], dtype=torch.int32, device=cuda)
            for v in (0, 1)}
    want = call(None)
    before = mod.launches
    call(flag[0])
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    for run in (flag[1], None):
        for got, ref in zip(call(run), want):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("kw", [{}, {"baseline": "leader"},
                                {"swap_early_stop": True},
                                {"cache_cols": 700},
                                {"sampling": "replacement",
                                 "baseline": "leader"},
                                {"sampling": "replacement",
                                 "swap_early_stop": True},
                                {"reuse": "pic"},
                                {"reuse": "pic", "cache_width": 300},
                                {"reuse": "pic", "cache_width": 1500,
                                 "cache_cols": 700}])
def test_cuda_fused_fit_equals_stepped_fit(cuda, kw):
    """On the card the device-resident driver (masked rounds through the
    kernels' run flag; replacement sampling's exact fallback through the
    streaming kernels' flag; the PIC ring's window moved a search at a
    time, a new round's block written by pairwise straight into its slot
    under the round's flag) and the
    stepped driver give the same report, loss bits included, and the
    fused one reads the device far less often."""
    n, k = 1500, 4
    X = datasets.mnist_like(n, seed=6)
    p = np.random.default_rng(0)
    perms = (np.stack([p.permutation(n) for _ in range(k)]),
             np.stack([p.permutation(n) for _ in range(4 * k + 10)]),
             p.integers(0, n, (k, -(-n // B), B)),
             p.integers(0, n, (4 * k + 10, -(-n // B), B)),
             p.permutation(n))
    fits = [BanditPAM(k, backend="cuda", device=cuda, fused=f, **kw).fit(
        X, layouts=rng.from_numpy(*perms)) for f in (True, False)]
    a, b_ = fits
    _same_fit(a, b_)
    assert a.build_rounds == b_.build_rounds
    assert a.swap_history == b_.swap_history and a.loss == b_.loss
    assert a.host_reads_by_phase["build"] < b_.host_reads_by_phase["build"]


def _sentinel_unwritten(outs):
    return all(bool((o.view(torch.int32) == 0x7fbadbad).all()) for o in outs)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kernel", ["pairwise", "swap_g_from_cache",
                                    "stream_build_g", "stream_swap_g"])
def test_flagged_kernels_run_flag(cuda, metric, kernel):
    """The run flag of the four kernels that gained it for the resident
    loop (a PIC round's pairwise into its ring slot, the cached SWAP
    round, the two exact fallbacks): at 1 the outputs equal the bits of
    no flag (NULL), and at 0 every block returns at once and an output
    filled with a sentinel is left untouched.  pairwise writes into a
    column slice of a ring (row stride 4·B), the others are called
    through their C entries with outputs the test owns."""
    from repro_torch.kernels import build as kbuild
    n, d, k, r = 1300, 64, 10, 700
    x = _x(n, d, 31, cuda)
    g = torch.Generator().manual_seed(7)
    y = x[torch.randperm(n, generator=g)[:B].to(cuda)].contiguous()
    flag = {v: torch.tensor([v], dtype=torch.int32, device=cuda)
            for v in (0, 1)}
    st = torch.cuda.current_stream(cuda).cuda_stream
    mid = pairwise.METRIC_IDS[metric]
    P = lambda t: t.data_ptr()

    def sentinel(*shape):
        return torch.full(shape, 0x7fbadbad, dtype=torch.int32,
                          device=cuda).view(torch.float32)

    if kernel == "pairwise":
        ring = sentinel(n, 4 * B)
        want = (ops.pairwise_distance(x, y, metric),)

        def call(run):
            slot = ring[:, B:2 * B]
            ops.pairwise_distance(x, y, metric, out=slot, run=run)
            return (slot,)
        outs = lambda: (ring,)
    else:
        med = x[torch.randperm(n, generator=g)[:k].to(cuda)].contiguous()
        yr = x[:r].contiguous() if kernel.startswith("stream") else y
        m = yr.shape[0]
        w = torch.ones(m, device=cuda)
        w[::9] = 0.0
        lg = torch.randn(m, generator=g).to(cuda)
        d1, d2, a = ops.stream_top2(yr, med, metric=metric)
        dn = d1.clone()
        dn[::7] = float("inf")
        shape = (n,) if kernel == "stream_build_g" else (k, n)
        bufs = [sentinel(*shape) for _ in range(3)]
        lib = kbuild.lib()
        dxy = ops.pairwise_distance(x, y, metric)

        def call(run):
            rp = None if run is None else P(run)
            o = [P(t) for t in bufs]
            if kernel == "swap_g_from_cache":
                code = lib.rt_swap_g_from_cache(
                    P(dxy), B, P(d1), P(d2), P(a), P(w), P(lg), *o, n, B, k,
                    rp, st)
            elif kernel == "stream_build_g":
                code = lib.rt_stream_build_g(P(x), P(yr), P(dn), P(w), P(lg),
                                             *o, n, r, d, mid, rp, st)
            else:
                sc, fl = swap_g.bin_scratch(cuda, n, r, k, 512, metric, 1, 0)
                code = lib.rt_stream_swap_g(P(x), P(yr), P(d1), P(d2), P(a),
                                            P(w), P(lg), *o, n, r, d, k, mid,
                                            rp, None if sc is None else P(sc),
                                            fl, st)
            kbuild.check(code, kernel)
            return tuple(t.clone() for t in bufs)
        outs = lambda: bufs
        want = None
    call(flag[0])
    torch.cuda.synchronize()
    assert _sentinel_unwritten(outs())
    got = call(flag[1])
    ref = call(None) if want is None else want
    for gv, rv in zip(got, ref):
        assert torch.equal(gv, rv)
    if kernel == "pairwise":
        # Only the slot was written; the rest of the ring kept its bytes.
        assert _sentinel_unwritten((ring[:, :B], ring[:, 2 * B:]))
