"""The card routes of the baselines, OneBatchPAM, the threefry draws and
the non-kernel metrics, against their ``"torch"`` versions on the card.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device (decided inside the fixture, never at import).  Run on the
card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_solvers.py``.

The solvers run on ``datasets.code_blobs``, integer points whose l2
distances both backends compute exactly, so the kernels and the plain
versions see the same distances: medoids, swaps and the ledger must be
equal, the loss agree to rtol 1e-5.  FasterPAM's card route (candidate
blocks through ``stream_swap_g``) is held against its plain route (one
candidate at a time), OneBatchPAM's SWAP (``swap_g_from_cache`` over
the block) against the plain math.
"""

import pytest
import torch

from repro_torch.api import KMedoids
from repro_torch.core import (baselines, datasets, onebatch, rng,
                              threefry)
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b):
    assert a.medoids.tolist() == b.medoids.tolist()
    assert a.n_swaps == b.n_swaps and a.converged == b.converged
    assert [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
    assert a.evals_by_phase == b.evals_by_phase
    assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)


def _blobs(cuda, n=2048, k=8, seed=19):
    return torch.from_numpy(datasets.code_blobs(n, k, seed=seed)).to(cuda)


@pytest.mark.parametrize("seed", [0, 5])
def test_threefry_card_equals_cpu(cuda, seed):
    key = threefry.PRNGKey(seed)
    for n in (1, 2, 100, 4097, 60000):
        assert torch.equal(threefry.permutation(key, n, cuda).cpu(),
                           threefry.permutation(key, n))
    for fn in (lambda d: threefry.randint(key, (3, 100), 0, 60000, d),
               lambda d: threefry.choice(key, 60000, (256,), False, d),
               lambda d: threefry.random_bits(key, (7, 9), d),
               lambda d: threefry.randint_rows(threefry.split(key, 5), 100,
                                               0, 650, d),
               lambda d: threefry.uniform(key, (1000,), -2.5, 7.3, d)):
        assert torch.equal(fn(cuda).cpu(), fn("cpu"))


def test_seed_layouts_card_equals_cpu(cuda):
    a, b = rng.from_seed(3, cuda, 4), rng.from_seed(3, "cpu", 4)
    n = 4097
    assert torch.equal(a.fixed_perm(n).cpu(), b.fixed_perm(n))
    assert torch.equal(a.swap_perm(2, n).cpu(), b.swap_perm(2, n))
    assert torch.equal(a.perm_on("build", 1, n, cuda).cpu(),
                       b.build_perm(1, n))
    assert torch.equal(a.build_draw(3, 5, n, 100).cpu(),
                       b.build_draw(3, 5, n, 100))


@pytest.mark.parametrize("block", [None, 257])
def test_fasterpam_card_route_matches_plain(cuda, block):
    """The default card block and a block that accepted swaps cut short,
    against the plain route, one candidate at a time."""
    X = _blobs(cuda)
    ops.reset_launch_counts()
    if block is None:
        a = baselines.fasterpam(X, 8, seed=2, backend="cuda", device=cuda)
    else:
        data, metric, be_name, dev = baselines._setup(X, "l2", "cuda", cuda)
        a = baselines._fasterpam_sweep(data, 8, metric, be_name, dev, block,
                                       seed=2)
    counts = ops.launch_counts()
    b = baselines.fasterpam(X, 8, seed=2, backend="torch", device=cuda)
    _same(a, b)
    assert a.n_swaps > 0
    assert counts["stream_swap_g"] >= 1 and counts["top2"] >= 1
    assert a.host_reads_by_phase["swap"] < b.host_reads_by_phase["swap"]


def test_voronoi_card_matches_torch(cuda, monkeypatch):
    """Four reference tiles of 512 columns on each backend."""
    monkeypatch.setattr(baselines, "VORONOI_TILE", 512)
    X = _blobs(cuda)
    ops.reset_launch_counts()
    a = baselines.voronoi_iteration(X, 8, seed=1, backend="cuda",
                                    device=cuda)
    counts = ops.launch_counts()
    b = baselines.voronoi_iteration(X, 8, seed=1, backend="torch",
                                    device=cuda)
    _same(a, b)
    assert counts["pairwise"] >= 4 and counts["top2"] >= 1


@pytest.mark.parametrize("solver", ["clarans", "clara"])
def test_clarans_clara_card_match_torch(cuda, solver):
    X = _blobs(cuda)
    fn = {"clarans": lambda **kw: baselines.clarans(X, 8, seed=3,
                                                    max_neighbors=60, **kw),
          "clara": lambda **kw: baselines.clara(X, 8, seed=3, **kw)}[solver]
    ops.reset_launch_counts()
    a = fn(backend="cuda", device=cuda)
    counts = ops.launch_counts()
    b = fn(backend="torch", device=cuda)
    _same(a, b)
    assert counts["top2"] >= 1


@pytest.mark.parametrize("init", [None, [0, 1, 2, 3, 4, 5, 6, 7]])
def test_onebatchpam_card_matches_torch(cuda, init):
    X = _blobs(cuda)
    ops.reset_launch_counts()
    a = onebatch.onebatchpam(X, 8, seed=4, init=init, backend="cuda",
                             device=cuda)
    counts = ops.launch_counts()
    b = onebatch.onebatchpam(X, 8, seed=4, init=init, backend="torch",
                             device=cuda)
    _same(a, b)
    assert a.n_swaps > 0
    assert counts["pairwise"] == 1 and counts["swap_g_from_cache"] >= 1


def test_precomputed_and_callable_fit_on_the_card(cuda):
    """The lookup and a callable run through "torch" on the card; the
    lookup of the exact l2 block gives the l2 fit's medoids."""
    from repro_torch.core.distances import l2
    X = _blobs(cuda, n=1024, k=6)
    D = l2(X, X)
    a = KMedoids(6, metric="precomputed", seed=0, device=cuda).fit(D)
    b = KMedoids(6, metric="l2", seed=0, device=cuda).fit(X)
    assert a.medoids_.tolist() == b.medoids_.tolist()
    assert a.predict(D[:50]).tolist() == b.labels_[:50].tolist()

    def cheb(x, y):
        return torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    c = KMedoids(6, metric=cheb, seed=0, device=cuda).fit(X)
    d = KMedoids(6, metric=cheb, seed=0, device="cpu").fit(X.cpu())
    assert c.medoids_.tolist() == d.medoids_.tolist()
    with pytest.raises(ValueError, match="has no kernel"):
        KMedoids(6, metric="precomputed", backend="cuda", device=cuda).fit(D)
