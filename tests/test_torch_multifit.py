"""Batched multi-fit in the port (``BanditPAM.fit_batch``,
``KMedoids.fit_batch``; ``repro_torch/core/batch.py``) held on the CPU.

* Against the live JAX ``fit_batch`` (``backend="jnp"``) on the same
  seeds: medoids, swap history, build rounds and ledger exact, the loss
  within rtol 1e-5 (the JAX package's masked loss over ``[n_max]`` rounds
  differently on a ragged batch; its own tests allow the same), on a
  ragged fixture (n = 180, 240, 300, 210 of ``mnist_like``'s first 16
  features) and a uniform one, both ``reuse`` modes, both baselines, l2
  and l1.  No case needed the leader's ledger allowance (ROADMAP §C).
* Against the port's own loop of single fits, bit for bit, loss bits
  included: every lane's arithmetic is the single fit's on its slice.
* The lockstep batch's reads and rounds: a batch of identical lanes
  reads exactly what one fit reads (``engine.host_read``) and enqueues as
  many rounds (one ``build_g`` / ``swap_g`` launch each on the card) as
  the single fit's statistics calls.
* A batch of one, lane-order independence, one seed on different data,
  the facade's labels against ``predict`` per lane, and the rejections of
  the JAX package's ``test_facade_rejects_unbatchable_configs``.
* The lane entry points of the kernels' modules (``ops.*_lanes``) on the
  CPU: each lane equals the single plain version on its slice, bit for
  bit, and the JAX kernel (interpret mode) within the tolerances of
  ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.core import BanditPAM as JBanditPAM
from repro.kernels import ops as jops
from repro_torch.api import KMedoids, available_batch_solvers
from repro_torch.core import BanditPAM, datasets, engine
from repro_torch.kernels import ops
from torch_threads import one_intra_op_thread  # noqa: F401

K = 3
RAGGED = [180, 240, 300, 210]
UNIFORM = [200, 200, 200]


def _batch(ns, seed0=0):
    return [datasets.mnist_like(n, seed=seed0 + i)[:, :16].copy()
            for i, n in enumerate(ns)]


def _same_decisions(got, want, tag):
    assert np.asarray(got.medoids).tolist() == \
        np.asarray(want.medoids).tolist(), tag
    assert [(o, x) for o, x, _ in got.swap_history] == \
        [(int(o), int(x)) for o, x, _ in want.swap_history], tag
    assert list(got.build_rounds) == [int(r) for r in want.build_rounds], tag
    assert got.evals_by_phase == {p: int(v) for p, v in
                                  want.evals_by_phase.items()}, tag
    assert got.distance_evals == want.distance_evals, tag
    assert got.cached_evals == want.cached_evals, tag
    assert got.converged == want.converged, tag


def _same_bits(got, want, tag):
    _same_decisions(got, want, tag)
    assert got.loss == want.loss, tag
    assert got.swap_history == want.swap_history, tag
    assert got.n_swaps == want.n_swaps, tag


# Cases whose fit 0 meets a float32 kill margin between the packages: the
# port's single fit of mnist_like(200, seed=0)[:, :16] at seed 0 pays
# 99,200 SWAP evaluations and the JAX single fit 99,100 (one arm-round of
# B = 100), with the same medoids and swaps (ROADMAP §C, "the ledger at
# seeds past 0").  There the ledger is held within 10·B, and each lane
# to the single fit of its own package.
MARGIN_CASES = {("uniform", "none", "none", "l2"),
                ("uniform", "none", "leader", "l2")}

CASES = ([("ragged", r, b, m) for r in ("none", "pic")
          for b in ("none", "leader") for m in ("l2", "l1")]
         + [("uniform", r, b, "l2") for r in ("none", "pic")
            for b in ("none", "leader")])


@pytest.mark.parametrize("shape,reuse,baseline,metric", CASES)
def test_fit_batch_matches_jax_fit_batch(shape, reuse, baseline, metric):
    ns = RAGGED if shape == "ragged" else UNIFORM
    Xs = _batch(ns)
    seeds = list(range(len(ns)))
    kw = dict(metric=metric, reuse=reuse, baseline=baseline)
    got = BanditPAM(K, device="cpu", **kw).fit_batch(Xs, seeds=seeds)
    want = JBanditPAM(K, backend="jnp", **kw).fit_batch(Xs, seeds=seeds)
    assert len(got) == len(want) == len(ns)
    margin = (shape, reuse, baseline, metric) in MARGIN_CASES
    for i, (g, w) in enumerate(zip(got, want)):
        tag = f"fit {i} n={ns[i]} ({shape}/{reuse}/{baseline}/{metric})"
        if margin and g.evals_by_phase != w.evals_by_phase:
            assert i == 0, tag
            _same_bits(g, BanditPAM(K, seed=seeds[i], device="cpu",
                                    **kw).fit(Xs[i]), tag)
            single = JBanditPAM(K, seed=seeds[i], backend="jnp",
                                **kw).fit(Xs[i])
            assert w.evals_by_phase == single.evals_by_phase, tag
            assert g.medoids.tolist() == np.asarray(w.medoids).tolist(), tag
            assert all(abs(v - w.evals_by_phase[p]) <= 10 * 100
                       for p, v in g.evals_by_phase.items()), tag
            continue
        _same_decisions(g, w, tag)
        np.testing.assert_allclose(g.loss, float(w.loss), rtol=1e-5,
                                   err_msg=tag)
    np.testing.assert_array_equal(got.medoids, np.asarray(want.medoids))
    np.testing.assert_array_equal(got.n_valid, np.asarray(want.n_valid))
    if reuse == "pic":
        assert all(r.cached_evals > 0 for r in got)


@pytest.mark.parametrize("reuse", ["none", "pic"])
@pytest.mark.parametrize("baseline", ["none", "leader"])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_fit_batch_equals_loop_of_single_fits(reuse, baseline, metric):
    Xs = _batch(RAGGED, seed0=10)
    seeds = [5, 6, 7, 8]
    kw = dict(metric=metric, reuse=reuse, baseline=baseline,
              swap_early_stop=baseline == "leader", device="cpu")
    got = BanditPAM(K, **kw).fit_batch(Xs, seeds=seeds)
    for i, (X, s) in enumerate(zip(Xs, seeds)):
        _same_bits(got[i], BanditPAM(K, seed=s, **kw).fit(X),
                   f"fit {i} ({reuse}/{baseline}/{metric})")
    assert set(got.wall_by_phase) == {"build", "swap"}
    assert got.dispatches_by_phase["build"] > 0
    assert got.dispatches_by_phase["swap"] > 0


class _CountStats:
    """Counts the plain backend's single statistics calls (one a round of
    a single fit) while installed."""

    def __init__(self, monkeypatch):
        self.calls = {"build": 0, "swap": 0}
        be = engine.TorchStatsBackend
        for phase, name in (("build", "build_stats"), ("swap", "swap_stats")):
            orig = getattr(be, name)

            def counted(self_, *a, _o=orig, _p=phase, **kw):
                self.calls[_p] += 1
                return _o(self_, *a, **kw)
            monkeypatch.setattr(be, name, counted)


def test_identical_lanes_read_and_round_like_one_fit(monkeypatch):
    """L identical lanes (same data, same seed) stop together, so the
    batch reads exactly what one fit reads and enqueues as many rounds as
    the single fit's statistics calls: the host cost does not grow with
    the batch."""
    X = _batch([650])[0]
    single = BanditPAM(K, seed=3, device="cpu").fit(X)
    counter = _CountStats(monkeypatch)
    BanditPAM(K, seed=3, device="cpu").fit(X)
    rounds = dict(counter.calls)
    monkeypatch.undo()
    batch = BanditPAM(K, device="cpu").fit_batch([X] * 4, seeds=[3] * 4)
    assert batch.host_reads_by_phase == single.host_reads_by_phase
    assert batch.dispatches_by_phase == rounds
    for r in batch:
        _same_bits(r, single, "identical lane")
        assert r.host_reads_by_phase == {} and r.wall_by_phase == {}


def test_batch_of_one_is_the_single_fit():
    X = _batch([230])[0]
    batch = BanditPAM(K, device="cpu").fit_batch([X], seeds=[5])
    single = BanditPAM(K, seed=5, device="cpu").fit(X)
    assert len(batch) == 1
    _same_bits(batch[0], single, "B=1")
    assert batch.host_reads_by_phase == single.host_reads_by_phase
    # A [B, n, d] array is a batch too.
    arr = BanditPAM(K, device="cpu").fit_batch(X[None], seeds=[5])
    _same_bits(arr[0], single, "[1, n, d]")


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_lane_order_does_not_matter(reuse):
    """No lane leaks into another: permuting the (dataset, seed) pairs
    permutes the results bit for bit."""
    Xs = _batch([190, 260, 150, 220], seed0=20)
    seeds = [11, 12, 13, 14]
    perm = [2, 0, 3, 1]
    bp = BanditPAM(K, metric="l1", reuse=reuse, device="cpu")
    a = bp.fit_batch(Xs, seeds=seeds)
    b = bp.fit_batch([Xs[p] for p in perm], seeds=[seeds[p] for p in perm])
    for j, p in enumerate(perm):
        _same_bits(b[j], a[p], f"lane {j} <- {p} ({reuse})")


def test_one_seed_on_different_data_gives_different_fits():
    Xs = _batch([200, 200], seed0=30)
    batch = BanditPAM(K, metric="l1", seed=4, device="cpu").fit_batch(Xs)
    assert (batch[0].medoids.tolist() != batch[1].medoids.tolist()
            or batch[0].loss != batch[1].loss)
    for X, r in zip(Xs, batch):
        _same_bits(r, BanditPAM(K, metric="l1", seed=4, device="cpu").fit(X),
                   "seeds=None takes the estimator's seed")


@pytest.mark.parametrize("solver", ["banditpam", "banditpam_pp"])
def test_facade_labels_match_predict_per_lane(solver):
    Xs = _batch(RAGGED, seed0=40)
    est = KMedoids(K, solver=solver, metric="l2", seed=0, device="cpu",
                   baseline="leader")
    rep = est.fit_batch(Xs, seeds=[1, 2, 3, 4])
    assert rep.labels.shape == (len(Xs), max(RAGGED))
    assert rep.solver == solver and rep.metric == "l2"
    for i, (X, n) in enumerate(zip(Xs, RAGGED)):
        single = KMedoids(K, solver=solver, metric="l2", seed=1 + i,
                          device="cpu", baseline="leader").fit(X)
        assert rep.medoids[i].tolist() == single.medoids_.tolist()
        np.testing.assert_array_equal(rep.labels[i, :n], single.labels_)
        np.testing.assert_array_equal(rep.labels[i, :n], single.predict(X))
        assert not rep.labels[i, n:].any()
    # A batch installs no single-fit state.
    assert est.report_ is None and est.medoids_ is None
    with pytest.raises(ValueError, match="not fitted"):
        est.predict(Xs[0])
    # The JAX facade's batch gives the same medoids and labels.
    jrep = JKMedoids(K, solver=solver, metric="l2", seed=0, backend="jnp",
                     baseline="leader").fit_batch(Xs, seeds=[1, 2, 3, 4])
    np.testing.assert_array_equal(rep.medoids, np.asarray(jrep.medoids))
    for i, n in enumerate(RAGGED):
        np.testing.assert_array_equal(rep.labels[i, :n], jrep.labels[i, :n])


def test_facade_rejects_unbatchable_configs():
    Xs = _batch([30, 30])
    assert available_batch_solvers() == ["banditpam", "banditpam_pp"]
    with pytest.raises(ValueError, match="no batched entrypoint"):
        KMedoids(K, solver="pam", device="cpu").fit_batch(Xs)
    with pytest.raises(KeyError, match="unknown solver"):
        KMedoids(K, solver="nope", device="cpu").fit_batch(Xs)
    with pytest.raises(ValueError, match="precomputed"):
        KMedoids(K, metric="precomputed", device="cpu").fit_batch(Xs)
    with pytest.raises(ValueError, match='sampling="permutation"'):
        BanditPAM(K, sampling="replacement", device="cpu").fit_batch(Xs)
    with pytest.raises(ValueError, match="cache_cols"):
        BanditPAM(K, cache_cols=32, device="cpu").fit_batch(Xs)
    with pytest.raises(ValueError, match="seeds"):
        BanditPAM(K, device="cpu").fit_batch(Xs, seeds=[1])
    with pytest.raises(ValueError, match="feature dim"):
        BanditPAM(K, device="cpu").fit_batch([Xs[0], Xs[1][:, :2]])
    with pytest.raises(ValueError, match="n > k"):
        BanditPAM(K, device="cpu").fit_batch([Xs[0], Xs[1][:K]])
    with pytest.raises(ValueError, match=r"\[B, n, d\]"):
        BanditPAM(K, device="cpu").fit_batch(Xs[0])


@pytest.mark.parametrize("n", [7, 256, 1037])
def test_batched_permutations_match_jax_batch_perms(n):
    """``threefry.permutations`` (the lanes of one n drawn together) is
    the JAX package's ``_batch_perms`` row for row, and each row is the
    single ``threefry.permutation``."""
    from repro.core.banditpam import _batch_perms, _batch_rng_chains
    from repro_torch.core import rng, threefry
    seeds = [0, 3, 2 ** 31 + 5]
    _, _, _, bpk, _ = _batch_rng_chains(jnp.asarray(
        np.asarray(seeds, np.uint32)), k=2, T=1)
    want = np.asarray(_batch_perms(bpk[:, 1], n=n))
    keys = [rng.from_seed(s, "cpu", 2).perm_key("build", 1) for s in seeds]
    got = threefry.permutations(keys, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for key, row in zip(keys, got):
        assert torch.equal(row, threefry.permutation(key, n))


# ---------------------------------------------------------------------------
# The lane entry points of the kernels' modules, on the CPU
# ---------------------------------------------------------------------------

LANE_ROWS = [130, 77, 101]
B = 40


def _lanes(d=33, seed=0):
    rng = np.random.default_rng(seed)
    n_pad = 144
    x = np.zeros((len(LANE_ROWS), n_pad, d), np.float32)
    for i, n in enumerate(LANE_ROWS):
        x[i, :n] = rng.standard_normal((n, d))
    y = rng.standard_normal((len(LANE_ROWS), B, d)).astype(np.float32)
    w = np.ones((len(LANE_ROWS), B), np.float32)
    w[:, -7:] = 0.0
    lg = rng.standard_normal((len(LANE_ROWS), B)).astype(np.float32)
    rows = torch.tensor(LANE_ROWS, dtype=torch.int32)
    return x, y, w, lg, rows, rng


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_build_g_lanes_plain_is_single_per_lane_and_matches_jax(metric):
    x, y, w, lg, rows, rng = _lanes(seed=1)
    dn = (rng.uniform(0.5, 3.0, w.shape) * 6).astype(np.float32)
    dn[:, :5] = np.inf
    got = ops.build_g_lanes_stats(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(dn), torch.from_numpy(w),
                                  torch.from_numpy(lg), rows=rows,
                                  metric=metric)
    for i, n in enumerate(LANE_ROWS):
        one = ops.build_g_stats(torch.from_numpy(x[i, :n]),
                                torch.from_numpy(y[i]),
                                torch.from_numpy(dn[i]),
                                torch.from_numpy(w[i]),
                                torch.from_numpy(lg[i]), metric=metric)
        for g, o in zip(got, one):
            assert torch.equal(g[i, :n], o)
            assert not g[i, n:].any()
        want = jops.build_g_stats(jnp.asarray(x[i, :n]), jnp.asarray(y[i]),
                                  jnp.asarray(dn[i]), jnp.asarray(w[i]),
                                  jnp.asarray(lg[i]), metric=metric,
                                  interpret=True)
        dmax = 30.0 if metric == "l1" else 10.0
        for g, wv, a in zip(got, want, (dmax * B, dmax ** 2 * B,
                                        dmax * 4 * B)):
            _close(g[i, :n].numpy(), np.asarray(wv), 1e-5 * a)


@pytest.mark.parametrize("k", [3, 5])
def test_swap_g_lanes_plain_is_single_per_lane_and_matches_jax(k):
    x, y, w, lg, rows, rng = _lanes(seed=k)
    d1 = (rng.uniform(0.0, 2.0, w.shape) * 6).astype(np.float32)
    d2 = d1 + (rng.uniform(0.0, 2.0, w.shape) * 6).astype(np.float32)
    a = rng.integers(0, k, w.shape).astype(np.int32)
    t = torch.from_numpy
    got = ops.swap_g_lanes_stats(t(x), t(y), t(d1), t(d2), t(a), t(w), k,
                                 t(lg), rows=rows, metric="l2")
    for i, n in enumerate(LANE_ROWS):
        one = ops.swap_g_stats(t(x[i, :n]), t(y[i]), t(d1[i]), t(d2[i]),
                               t(a[i]), t(w[i]), k, t(lg[i]), metric="l2")
        for g, o in zip(got, one):
            assert g.shape == (len(LANE_ROWS), k, 144)
            assert torch.equal(g[i, :, :n], o)
        want = jops.swap_g_stats(
            jnp.asarray(x[i, :n]), jnp.asarray(y[i]), jnp.asarray(d1[i]),
            jnp.asarray(d2[i]), jnp.asarray(a[i]), jnp.asarray(w[i]), k,
            jnp.asarray(lg[i]), metric="l2", interpret=True)
        dmax = 24.0
        for g, wv, at in zip(got, want, (dmax * B, dmax ** 2 * B,
                                         dmax * 4 * B)):
            _close(g[i, :, :n].numpy(), np.asarray(wv), 1e-5 * at)


def test_top2_lanes_plain_is_single_per_lane_and_matches_jax():
    x, _, _, _, rows, rng = _lanes(seed=9)
    # Medoid rows off the data: an l2 self-distance is the square root of
    # the summation noise, which differs between the packages (ROADMAP §C).
    med = rng.standard_normal((len(LANE_ROWS), 4, x.shape[2])).astype(
        np.float32)
    got = ops.stream_top2_lanes(torch.from_numpy(x), torch.from_numpy(med),
                                rows=rows, metric="l2")
    for i, n in enumerate(LANE_ROWS):
        one = ops.stream_top2(torch.from_numpy(x[i, :n]),
                              torch.from_numpy(med[i]), metric="l2")
        for g, o in zip(got, one):
            assert torch.equal(g[i, :n], o)
        want = jops.stream_top2(jnp.asarray(x[i, :n]), jnp.asarray(med[i]),
                                metric="l2", interpret=True)
        _close(got[0][i, :n].numpy(), np.asarray(want[0]), 1e-4)
        np.testing.assert_array_equal(got[2][i, :n].numpy(),
                                      np.asarray(want[2]))


def test_lane_entry_points_validate_inputs():
    x, y, w, lg, rows, _ = _lanes()
    t = torch.from_numpy
    with pytest.raises(ValueError, match="rows"):
        ops.build_g_lanes_stats(t(x), t(y), t(w), t(w), rows=rows.long())
    with pytest.raises(ValueError, match="run"):
        ops.build_g_lanes_stats(t(x), t(y), t(w), t(w),
                                run=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="batch vectors"):
        ops.swap_g_lanes_stats(t(x), t(y), t(np.ascontiguousarray(w[:, :3])),
                               t(w), t(w).int(),
                               t(w), 2)
    with pytest.raises(ValueError, match="shapes"):
        ops.stream_top2_lanes(t(x), t(y[:2]))


class _KernelEntriesOnCpu(engine.CudaStatsBackend):
    """The ``"cuda"`` backend's wiring (batch gathers, leader rows, run
    flags, row counts) through the kernel entry points of ``ops``, which
    take their plain versions for CPU tensors."""

    @staticmethod
    def _ops(t):
        return ops


@pytest.mark.parametrize("baseline", ["none", "leader"])
def test_kernel_backend_wiring_on_the_cpu(monkeypatch, baseline):
    """``fit_batch`` through the kernel backend's lane methods (with the
    kernels' plain versions) equals the single fits through its single
    methods: the validation of every lane entry point's inputs (shapes,
    dtypes, contiguity) runs as on the card."""
    monkeypatch.setitem(engine._BACKENDS, "kernels-on-cpu",
                        _KernelEntriesOnCpu())
    Xs = _batch([150, 233, 190], seed0=60)
    kw = dict(metric="l2", baseline=baseline, backend="kernels-on-cpu",
              device="cpu")
    got = BanditPAM(K, **kw).fit_batch(Xs, seeds=[1, 2, 3])
    for i, (X, s) in enumerate(zip(Xs, [1, 2, 3])):
        _same_bits(got[i], BanditPAM(K, seed=s, **kw).fit(X),
                   f"fit {i} ({baseline})")
