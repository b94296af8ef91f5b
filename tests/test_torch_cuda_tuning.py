"""The tile tuner's shapes on the card: every compiled shape of every
kernel gives the default shape's bits (the shape the unchanged ``rt_*``
entries take) at small shapes, with ragged lanes and the run flag at 0;
a fit forced to each candidate config gives the default config's report;
an index the library lacks raises; the tuner's tables match the
library's shape queries.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device.  Run on the card with ``python -m pytest --noconftest -m
gpu tests/test_torch_cuda_tuning.py``.
"""

import pytest
import torch

from repro_torch.core import BanditPAM, DistributedBanditPAM, datasets, tuning
from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g

pytestmark = pytest.mark.gpu

LANES = (300, 257, 130, 17)  # ragged, lane 3 masked where there is a flag


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tuning.clear_ledger()
    yield torch.device("cuda")
    tuning.clear_ledger()


def _x(n, d, seed, dev):
    return torch.from_numpy(datasets.mnist_like(n, seed=seed, d=d)).to(dev)


def _bits(ts):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in ts]


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))


def _each(kernel, default, call):
    want = call(default)
    for s in range(len(tuning.KERNEL_SHAPES[kernel])):
        assert _equal(call(s), want), (kernel, s)


def _ragged(outs):
    return tuple(o[i, ..., :n] for o in outs
                 for i, n in enumerate(LANES[:3]))


@pytest.mark.parametrize("d", [33, 64])
@pytest.mark.parametrize("metric", ["l2", "cosine", "l1"])
def test_every_shape_gives_the_default_bits(cuda, metric, d):
    g = torch.Generator(device="cpu").manual_seed(d)
    x = _x(1000, d, 0, cuda)
    y = _x(130, d, 1, cuda)
    med = x[torch.randperm(1000, generator=g)[:10].to(cuda)].contiguous()
    for a, b in ((x, y), (x, y[:100]), (x, med), (x[:1], x)):
        _each("pairwise", tuning.pairwise_index(128, 104, a.shape[0],
                                                b.shape[0]),
              lambda s: (pairwise.launch(a, b, metric, shape=s),))
    flag0 = torch.zeros(1, dtype=torch.int32, device=cuda)
    for s in range(len(tuning.PAIRWISE_SHAPES)):
        ring = torch.full((1000, 300), float("nan"), device=cuda)
        pairwise.launch(x, y[:100], metric, ring[:, 100:200], flag0, shape=s)
        assert torch.isnan(ring).all()
    b = 100
    yb = y[:b].contiguous()
    dn = pairwise.pairwise_torch(yb, med, metric=metric).min(dim=1).values
    dn[:3] = float("inf")
    w = torch.ones(b, device=cuda)
    w[-5:] = 0.0
    lg = torch.randn(b, generator=g).to(cuda)
    _each("build_g", 0, lambda s: build_g.launch(x, yb, dn, w, lg, metric,
                                                 shape=s))
    _each("stream_build_g", 0, lambda s: stream_g.launch_stream_build(
        x, x, torch.full((1000,), float("inf"), device=cuda),
        torch.ones(1000, device=cuda), torch.zeros(1000, device=cuda),
        metric, shape=s))
    for k, bb in ((10, 100), (40, 100), (10, 130)):
        yy = y[:bb].contiguous()
        mk = x[torch.randperm(1000, generator=g)[:k].to(cuda)].contiguous()
        d1, d2, a = stream_g.top2_torch(yy, mk, metric)
        wb, lgb = torch.ones(bb, device=cuda), torch.randn(bb, generator=g)
        _each("swap_g", 0, lambda s: swap_g.launch(
            x, yy, d1, d2, a, wb, k, lgb.to(cuda), metric, shape=s))
    d1, d2, a = stream_g.top2_torch(x, med, metric)
    ones = torch.ones(1000, device=cuda)
    _each("stream_swap_g", 0, lambda s: stream_g.launch_stream_swap(
        x, x, d1, d2, a, ones, 10, torch.zeros(1000, device=cuda), metric,
        shape=s))
    for k in (10, 40, 65):
        mk = x[torch.randperm(1000, generator=g)[:k].to(cuda)].contiguous()
        _each("top2", tuning.top2_index(tuning.top2_tile(k)),
              lambda s: stream_g.launch_top2(x, mk, metric, shape=s))


def test_lane_forms_give_the_default_bits(cuda):
    g = torch.Generator(device="cpu").manual_seed(4)
    L, n_pad, b, d = len(LANES), LANES[0], 100, 40
    xl = _x(L * n_pad, d, 0, cuda).view(L, n_pad, d)
    yl = _x(L * b, d, 1, cuda).view(L, b, d)
    rows = torch.tensor(LANES, dtype=torch.int32, device=cuda)
    run = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=cuda)
    yrows = torch.tensor([b, b, 63, b], dtype=torch.int32, device=cuda)
    col = torch.tensor([0, b, 37, 2 * b], dtype=torch.int64, device=cuda)

    def pw(s):
        out = torch.full((L, n_pad, 4 * b), float("nan"), device=cuda)
        return (pairwise.launch_lanes(xl, yl, "l2", out, col, rows, yrows,
                                      run, shape=s),)
    _each("pairwise", 2, pw)
    dn = torch.rand(L, b, generator=g).to(cuda)
    w = torch.ones(L, b, device=cuda)
    lg = torch.randn(L, b, generator=g).to(cuda)
    _each("build_g", 0, lambda s: _ragged(build_g.launch_lanes(
        xl, yl, dn, w, lg, rows, "l2", run, shape=s)))
    med = xl[:, :10].contiguous()
    d1, d2, a = stream_g.launch_top2_lanes(yl, med, None, "l2", shape=0)
    _each("swap_g", 0, lambda s: _ragged(swap_g.launch_lanes(
        xl, yl, d1, d2, a, w, 10, lg, rows, "l2", run, shape=s)))
    _each("top2", 0, lambda s: _ragged(stream_g.launch_top2_lanes(
        xl, med, rows, "l2", shape=s)))


def test_unknown_indices_raise_and_tables_match_the_library(cuda):
    x = _x(200, 16, 0, cuda)
    y = x[:20].contiguous()
    for kernel, shapes in tuning.KERNEL_SHAPES.items():
        for s, (bm, bn) in enumerate(shapes):
            got = tuning.shape_info(kernel, s, 10)
            assert got[:2] == (bm, bn) and got[3] >= 1, (kernel, s, got)
        with pytest.raises(RuntimeError):
            tuning.shape_info(kernel, len(shapes), 10)
    with pytest.raises(RuntimeError):
        pairwise.launch(x, y, "l2", shape=len(tuning.PAIRWISE_SHAPES))
    with pytest.raises(RuntimeError):
        stream_g.launch_top2(x, y, "l2", shape=len(tuning.TOP2_SHAPES))
    w = torch.ones(20, device=cuda)
    with pytest.raises(RuntimeError):
        build_g.launch(x, y, w, w, w, "l2", shape=3)
    d1, d2, a = stream_g.top2_torch(y, y[:3], "l2")
    with pytest.raises(RuntimeError):
        swap_g.launch(x, y, d1, d2, a, w, 3, w, "l2", shape=3)
    with pytest.raises(RuntimeError):
        swap_g.launch_cached(pairwise.pairwise_torch(x, y), d1, d2, a, w, 3,
                             w, shape=1)
    with pytest.raises(ValueError):
        ops.pairwise_distance(x, y, tm=96)
    cfg = tuning.resolve_tile_config(60000, 784, 10,
                                     tuning.current_device_kind(cuda), "cuda")
    assert cfg in tuning.candidates(60000, 784, 10,
                                    tuning.current_device_kind(cuda), "cuda")


N, D, K = 1500, 64, 4


def _forced(cfg, cuda, est):
    kind = tuning.current_device_kind(cuda)
    tuning.clear_ledger()
    tuning.observe(N, D, K, cfg, {"build": 1e-9}, kind, "cuda")
    r = est.fit(datasets.mnist_like(N, seed=2, d=D))
    assert tuning.resolve_tile_config(N, D, K, kind, "cuda") == cfg
    return r


def _candidates():
    return tuning.candidates(N, D, K, "any card", "torch") + [
        tuning.TileConfig(tm=32, tr=128, tk=104, dk=D)]


@pytest.mark.parametrize("i", range(len(_candidates())))
@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_fit_under_each_candidate_gives_the_default_report(cuda, reuse, i):
    floor = tuning.TileConfig(tm=128, tr=104, tk=16, dk=D)
    fields = ("medoids", "swap_history", "build_rounds", "evals_by_phase",
              "loss", "n_swaps")
    for est in (BanditPAM(K, seed=0, reuse=reuse, batch_size=64),
                DistributedBanditPAM(K, reuse=reuse, batch_size=64)):
        want = _forced(floor, cuda, est)
        got = _forced(_candidates()[i], cuda, est)
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            assert (a.tolist() if f == "medoids" else a) == (
                b.tolist() if f == "medoids" else b), (type(est), f)
