"""The port's baselines (``repro_torch.core.baselines``: FasterPAM,
Voronoi iteration, CLARANS, CLARA) held against the JAX package's on the
CPU, through the solver functions and the ``KMedoids`` facade.

Both packages draw with ``np.random.default_rng(seed)``, so the same
seed walks the same trajectory: medoids, ``n_swaps``, ``distance_evals``,
``evals_by_phase`` and ``converged`` must be equal, the loss agree to
rtol 1e-5 (float32 summation order).  FasterPAM's block route (the card's
way: a block of candidates scored at once by the streaming SWAP
statistics, cut short at the first improving swap) must equal its
one-candidate-at-a-time route, decisions and ledger.
"""

import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.api import registry as jregistry
from repro.core import baselines as jbaselines
from repro.core import datasets as jdatasets
from repro_torch.api import KMedoids, registry
from repro_torch.core import baselines, engine
from torch_threads import one_intra_op_thread  # noqa: F401

FIXTURES = [(300, 3, "l2"), (260, 4, "l1"), (240, 5, "cosine")]


def _same(got, want):
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert got.n_swaps == want.n_swaps
    assert got.distance_evals == want.distance_evals
    assert got.evals_by_phase == want.evals_by_phase
    assert got.converged == want.converged
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)


def fasterpam_at_block(X, k, block, *, metric="l2", backend="auto",
                       device="cpu", **kw):
    """FasterPAM's sweep at a chosen candidate block (0: one candidate
    at a time)."""
    data, metric, be_name, dev = baselines._setup(X, metric, backend, device)
    return baselines._fasterpam_sweep(data, k, metric, be_name, dev, block,
                                      **kw)


def _blocks(monkeypatch):
    """(first position, length) of every candidate block the torch
    backend's streaming SWAP sums scored."""
    blocks = []
    orig = engine.TorchStatsBackend.stream_swap_sums

    def spy(self_, *a, rows=None, **kw):
        if rows is not None:
            blocks.append((int(rows[0]), rows.numel()))
        return orig(self_, *a, rows=rows, **kw)
    monkeypatch.setattr(engine.TorchStatsBackend, "stream_swap_sums", spy)
    return blocks


@pytest.mark.parametrize("n,k,metric", FIXTURES)
@pytest.mark.parametrize("seed", [0, 3])
def test_fasterpam_matches_jax(n, k, metric, seed):
    X = jdatasets.mnist_like(n, seed=1)
    want = jbaselines.fasterpam(X, k, metric=metric, seed=seed)
    got = baselines.fasterpam(X, k, metric=metric, seed=seed, device="cpu")
    _same(got, want)
    assert got.n_swaps > 0 and got.converged


@pytest.mark.parametrize("block", [1, 37, 4096])
def test_fasterpam_block_route_equals_candidate_route(block, monkeypatch):
    """Every block size gives the one-at-a-time route's fit (past 1, with
    fewer reads).  At 37 and 4096 accepted swaps cut blocks short: the next
    block starts right after the swap, not after the block."""
    n, k = 300, 4
    X = jdatasets.mnist_like(n, seed=2)
    want = baselines.fasterpam(X, k, seed=1, device="cpu")
    blocks = _blocks(monkeypatch)
    got = fasterpam_at_block(X, k, block, seed=1)
    _same(got, want)
    assert got.n_swaps > 0
    if block > 1:
        assert (got.host_reads_by_phase["swap"]
                < want.host_reads_by_phase["swap"])
    cut = sum((lo + span) % n != nxt
              for (lo, span), (nxt, _) in zip(blocks, blocks[1:]))
    assert (cut > 0) == (block > 1)


@pytest.mark.parametrize("block", [0, 64])
def test_fasterpam_init_and_step_budget(block):
    n, k = 300, 3
    X = jdatasets.mnist_like(n, seed=5)
    init = [10, 20, 30]
    want = jbaselines.fasterpam(X, k, init=init)
    _same(fasterpam_at_block(X, k, block, init=init), want)
    want = jbaselines.fasterpam(X, k, seed=2, max_steps=150)
    got = fasterpam_at_block(X, k, block, seed=2, max_steps=150)
    _same(got, want)
    assert not got.converged


@pytest.mark.parametrize("n,k,metric", FIXTURES)
@pytest.mark.parametrize("seed", [0, 3])
def test_voronoi_matches_jax(n, k, metric, seed, monkeypatch):
    """One reference tile, and several (the cost summed tile by tile)."""
    X = jdatasets.mnist_like(n, seed=1)
    want = jbaselines.voronoi_iteration(X, k, metric=metric, seed=seed)
    for tile in (64, 4096):
        monkeypatch.setattr(baselines, "VORONOI_TILE", tile)
        got = baselines.voronoi_iteration(X, k, metric=metric, seed=seed,
                                          device="cpu")
        _same(got, want)


def test_voronoi_empty_cluster_keeps_its_medoid(monkeypatch):
    """Four distinct points, ten copies each: the seed's draw takes two
    copies of one point, so every point ties to the lower of the two and
    the other's cluster is empty; the update keeps that medoid, as the
    JAX package's does, and the whole fit agrees."""
    from repro.core.baselines import _voronoi_update
    base = np.array([[0.0, 0.0], [5.0, 0.0], [0.0, 5.0], [9.0, 9.0]],
                    np.float32)
    X = np.repeat(base, 10, axis=0)
    seed, k = 0, 3
    drawn = np.random.default_rng(seed).choice(40, size=k, replace=False)
    groups = [int(i) // 10 for i in drawn]
    assert len(set(groups)) < k                         # two copies drawn
    empty = max(j for j in range(k) if groups[j] in groups[:j])
    data = torch.from_numpy(X)
    med = torch.as_tensor(drawn.astype(np.int64))
    monkeypatch.setattr(baselines, "VORONOI_TILE", 16)
    new = baselines._voronoi_update(engine.get_stats_backend("torch"), data,
                                    med, k, "l2", "torch")
    jnew, _ = _voronoi_update(X, drawn.astype(np.int32), metric="l2", k=k)
    assert new.tolist() == np.asarray(jnew).tolist()
    assert int(new[empty]) == int(drawn[empty])
    _same(baselines.voronoi_iteration(X, k, seed=seed, device="cpu"),
          jbaselines.voronoi_iteration(X, k, seed=seed))


@pytest.mark.parametrize("n,k,metric", FIXTURES)
def test_clarans_matches_jax(n, k, metric):
    X = jdatasets.mnist_like(n, seed=1)
    want = jbaselines.clarans(X, k, metric=metric, seed=4, max_neighbors=40)
    got = baselines.clarans(X, k, metric=metric, seed=4, max_neighbors=40,
                            device="cpu")
    _same(got, want)


def test_clarans_default_budget_matches_jax():
    X = jdatasets.mnist_like(200, seed=3)
    _same(baselines.clarans(X, 3, seed=1, device="cpu"),
          jbaselines.clarans(X, 3, seed=1))


@pytest.mark.parametrize("n,k,metric", FIXTURES)
@pytest.mark.parametrize("kw", [{}, {"n_samples": 3, "sample_size": 30}])
def test_clara_matches_jax(n, k, metric, kw):
    X = jdatasets.mnist_like(n, seed=1)
    want = jbaselines.clara(X, k, metric=metric, seed=2, **kw)
    got = baselines.clara(X, k, metric=metric, seed=2, device="cpu", **kw)
    _same(got, want)


@pytest.mark.parametrize("solver,params", [
    ("fasterpam", {}), ("voronoi", {}), ("clarans", {"max_neighbors": 30}),
    ("clara", {})])
def test_facade_matches_jax(solver, params):
    X = jdatasets.mnist_like(220, seed=7)
    jest = JKMedoids(3, solver=solver, seed=5, **params).fit(X)
    est = KMedoids(3, solver=solver, seed=5, device="cpu", **params).fit(X)
    _same(est.report_, jest.report_)
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    assert est.report_.solver == solver
    Q = jdatasets.mnist_like(50, seed=8)
    np.testing.assert_array_equal(est.predict(Q), jest.predict(Q))


def test_registry_matches_jax():
    """Every solver of the JAX registry is here, the sharded fit
    included, with the same batched entry points, and the recommended
    params agree."""
    assert not hasattr(registry, "NOT_PORTED")
    assert registry.available_solvers() == jregistry.available_solvers()
    assert (registry.available_batch_solvers()
            == jregistry.available_batch_solvers())
    assert registry.BANDIT_SOLVERS == jregistry.BANDIT_SOLVERS
    for name in jregistry.available_solvers():
        assert registry.default_params(name) == jregistry.default_params(name)
        assert callable(registry.get_solver(name))
    assert registry.default_params("banditpam_dist") == {}
    assert registry.solver_accepts_backend("banditpam_dist")


def test_baselines_take_a_backend():
    X = torch.from_numpy(jdatasets.mnist_like(60, seed=0, d=16))
    for fn in (baselines.fasterpam, baselines.voronoi_iteration,
               baselines.clarans, baselines.clara):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(X, 2, backend="cuda", device="cpu")
