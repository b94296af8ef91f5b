"""The lockstep PIC batch (``fit_batch`` under ``reuse="pic"``,
``repro_torch/core/batch.py``) and its two lane kernels' plain versions,
held on the CPU.

* ``ops.pairwise_lanes`` and ``ops.swap_g_from_cache_lanes_stats``: each
  lane equals the single plain version on its own slice bit for bit
  (written at, or read from, its own column offset of a lane ring; a
  lane whose run flag reads 0 keeps its output), and the JAX package's
  ``pairwise_ref`` / ``swap_g_stats_cached`` (interpret mode) within the
  tolerances of ``tests/test_torch_kernels.py`` and
  ``tests/test_torch_pic.py``.
* A ragged batch at ``batch_size=20``, ``cache_width=200`` (a ring of
  10 rounds): a lane of at most 200 points carries its SWAP moments,
  the others recycle and start every SWAP search cold, so searches run
  carried lanes beside cold ones.  Every lane equals its single fit bit
  for bit (loss bits and the fresh / cached ledger included), under both
  baselines, and the batch matches the JAX ``fit_batch(reuse="pic")``
  within the allowances of ``test_fit_batch_matches_jax_fit_batch``.
* Identical PIC lanes read and enqueue rounds as one fit does.
* The ``"cuda"`` backend's PIC lane wiring through the kernel entry
  points (their plain versions on the CPU) equals its single fits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BanditPAM as JBanditPAM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import BanditPAM, banditpam, batch, datasets, engine
from repro_torch.kernels import ops
from torch_threads import one_intra_op_thread  # noqa: F401

K = 3
RING = dict(reuse="pic", batch_size=20, cache_width=200)
LANE_ROWS = [130, 77, 101]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bits(got, want, tag):
    assert got.medoids.tolist() == want.medoids.tolist(), tag
    assert got.loss == want.loss, tag
    assert got.swap_history == want.swap_history, tag
    assert list(got.build_rounds) == list(want.build_rounds), tag
    assert got.evals_by_phase == want.evals_by_phase, tag
    assert got.cached_evals == want.cached_evals, tag
    assert got.converged == want.converged, tag


# ---------------------------------------------------------------------------
# The lane kernels' plain versions
# ---------------------------------------------------------------------------

def _ring_inputs(d=33, b=40, seed=0):
    rng = np.random.default_rng(seed)
    n_pad = 144
    x = np.zeros((len(LANE_ROWS), n_pad, d), np.float32)
    for i, n in enumerate(LANE_ROWS):
        x[i, :n] = rng.standard_normal((n, d))
    y = rng.standard_normal((len(LANE_ROWS), b, d)).astype(np.float32)
    rows = torch.tensor(LANE_ROWS, dtype=torch.int32)
    return x, y, rows, rng


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_pairwise_lanes_plain_is_single_per_lane_and_matches_jax(metric):
    x, y, rows, _ = _ring_inputs(seed=1)
    b = y.shape[1]
    # Fresh PIC columns: each lane's rows against its batch, into a ring
    # [L, n_pad, 3·b] at its own column; lane 1 at run flag 0 keeps its.
    store = torch.full((len(LANE_ROWS), x.shape[1], 3 * b), 7.0)
    col = torch.tensor([b, 2 * b, 0], dtype=torch.int64)
    run = torch.tensor([1, 0, 1], dtype=torch.int32)
    ops.pairwise_lanes(_t(x), _t(y), metric, out=store, col=col,
                       xrows=rows, run=run)
    # d_near rows: each lane's first row against its own rows.
    dn = ops.pairwise_lanes(_t(x[:, :1]), _t(x), metric, yrows=rows)
    for i, n in enumerate(LANE_ROWS):
        c = int(col[i])
        blk = store[i, :n, c:c + b]
        one = ops.pairwise_distance(_t(x[i, :n]), _t(y[i]), metric)
        if run[i]:
            assert torch.equal(blk, one)
            want = np.asarray(jref.pairwise_ref(jnp.asarray(x[i, :n]),
                                                jnp.asarray(y[i]), metric))
            np.testing.assert_allclose(blk.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        else:
            assert torch.equal(blk, torch.full_like(blk, 7.0))
        rest = torch.ones(store.shape[2], dtype=torch.bool)
        rest[c:c + b] = False
        assert torch.equal(store[i, :n, rest],
                           torch.full_like(store[i, :n, rest], 7.0))
        assert torch.equal(dn[i, 0, :n], ops.pairwise_distance(
            _t(x[i, :1]), _t(x[i, :n]), metric)[0])


@pytest.mark.parametrize("k", [3, 5])
def test_swap_g_from_cache_lanes_plain_is_single_per_lane_and_matches_jax(k):
    """Each lane's block is read at its own column of the lane ring (a
    round's slot, or the scratch); lane 2's flag at 0 is computed all
    the same by the plain version, whose outputs the caller discards."""
    rng = np.random.default_rng(k)
    b, W = 40, 3
    L, n_pad = len(LANE_ROWS), 144
    store = rng.uniform(0.0, 12.0, (L, n_pad, (W + 1) * b)).astype(
        np.float32)
    d1 = rng.uniform(0.0, 6.0, (L, b)).astype(np.float32)
    d2 = d1 + rng.uniform(0.0, 6.0, (L, b)).astype(np.float32)
    a = rng.integers(0, k, (L, b)).astype(np.int32)
    w = (rng.uniform(size=(L, b)) > 0.1).astype(np.float32)
    lg = rng.standard_normal((L, b)).astype(np.float32)
    col = torch.tensor([2 * b, W * b, 0], dtype=torch.int64)
    rows = torch.tensor(LANE_ROWS, dtype=torch.int32)
    got = ops.swap_g_from_cache_lanes_stats(
        _t(store), _t(d1), _t(d2), _t(a), _t(w), k, _t(lg), col=col,
        rows=rows, run=torch.tensor([1, 1, 0], dtype=torch.int32))
    atols = (1e-5 * 12.0 * b, 1e-5 * 12.0 ** 2 * b,
             1e-5 * 12.0 * np.abs(lg).max() * b)
    for i, n in enumerate(LANE_ROWS):
        c = int(col[i])
        blk = store[i, :n, c:c + b]
        one = ops.swap_g_stats_cached(_t(blk), _t(d1[i]), _t(d2[i]),
                                      _t(a[i]), _t(w[i]), k, _t(lg[i]))
        want = jops.swap_g_stats_cached(
            jnp.asarray(blk), jnp.asarray(d1[i]), jnp.asarray(d2[i]),
            jnp.asarray(a[i]), jnp.asarray(w[i]), k, jnp.asarray(lg[i]),
            interpret=True)
        for g, o, wv, at in zip(got, one, want, atols):
            assert g.shape == (L, k, n_pad)
            assert torch.equal(g[i, :, :n], o)
            assert not g[i, :, n:].any()
            np.testing.assert_allclose(g[i, :, :n].numpy(), np.asarray(wv),
                                       rtol=1e-5, atol=at)


def test_pic_lane_entry_points_validate_inputs():
    x, y, rows, _ = _ring_inputs()
    store = torch.zeros((3, 144, 120))
    with pytest.raises(ValueError, match="col needs out"):
        ops.pairwise_lanes(_t(x), _t(y), col=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="col"):
        ops.pairwise_lanes(_t(x), _t(y), out=store,
                           col=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="out"):
        ops.pairwise_lanes(_t(x), _t(y), out=torch.zeros((3, 144, 10)))
    with pytest.raises(ValueError, match="xrows"):
        ops.pairwise_lanes(_t(x), _t(y), xrows=rows.long())
    v = torch.ones(3, 40)
    a = torch.zeros(3, 40, dtype=torch.int32)
    with pytest.raises(ValueError, match="batch vectors"):
        ops.swap_g_from_cache_lanes_stats(store, v[:2], v[:2], a[:2], v[:2],
                                          2)
    with pytest.raises(ValueError, match="adjacent"):
        ops.swap_g_from_cache_lanes_stats(store.transpose(1, 2)[:, :40],
                                          v, v, a, v, 2)
    with pytest.raises(ValueError, match="columns in a ring"):
        ops.swap_g_from_cache_lanes_stats(store[:, :, :30], v, v, a, v, 2)


# ---------------------------------------------------------------------------
# The lockstep PIC batch
# ---------------------------------------------------------------------------

RAGGED = [180, 240, 300, 210]


def _batch(ns, seed0=0):
    return [datasets.mnist_like(n, seed=seed0 + i)[:, :16].copy()
            for i, n in enumerate(ns)]


class _CarrySpy:
    """Records each SWAP iteration's carrying lanes (the repair's run
    flags) while installed."""

    def __init__(self, monkeypatch):
        self.flags = []
        orig = batch._carry_delta_lanes

        def spy(*a, **kw):
            self.flags.append(a[-1].tolist())
            return orig(*a, **kw)
        monkeypatch.setattr(batch, "_carry_delta_lanes", spy)


@pytest.mark.parametrize("baseline", ["none", "leader"])
def test_recycling_and_carrying_pic_batch_equals_loop(monkeypatch, baseline):
    Xs = _batch([180, 240, 300, 150, 199], seed0=30)
    seeds = [1, 2, 3, 4, 5]
    kw = dict(RING, baseline=baseline, swap_early_stop=baseline == "leader",
              device="cpu")
    spy = _CarrySpy(monkeypatch)
    got = BanditPAM(K, **kw).fit_batch(Xs, seeds=seeds)
    monkeypatch.undo()
    for i, (X, s) in enumerate(zip(Xs, seeds)):
        _same_bits(got[i], BanditPAM(K, seed=s, **kw).fit(X),
                   f"fit {i} ({baseline})")
        assert got[i].evals_by_phase["swap_cached"] > 0
    # Lanes 0, 3 and 4 (at most 10 rounds) carry; 1 and 2 recycle.
    assert spy.flags and all(f[1] == f[2] == 0 for f in spy.flags)
    assert any(f[0] or f[3] or f[4] for f in spy.flags)


@pytest.mark.parametrize("baseline", ["none", "leader"])
def test_recycling_and_carrying_pic_batch_matches_jax_fit_batch(baseline):
    """Against the live JAX ``fit_batch`` on the fixture of
    ``test_fit_batch_matches_jax_fit_batch``, with its allowances:
    medoids, swaps and build rounds exact, the loss within rtol 1e-5,
    and the ledger exact except where the two packages' SINGLE fits
    already differ by a float32 kill margin (each batch lane equal to
    its own package's single fit), there within 10·B."""
    Xs = _batch(RAGGED)
    seeds = list(range(len(RAGGED)))
    kw = dict(RING, baseline=baseline)
    got = BanditPAM(K, device="cpu", **kw).fit_batch(Xs, seeds=seeds)
    want = JBanditPAM(K, backend="jnp", **kw).fit_batch(Xs, seeds=seeds)
    for i, (g, w) in enumerate(zip(got, want)):
        tag = f"fit {i} n={RAGGED[i]} ({baseline})"
        assert g.medoids.tolist() == np.asarray(w.medoids).tolist(), tag
        assert [(o, x) for o, x, _ in g.swap_history] == \
            [(int(o), int(x)) for o, x, _ in w.swap_history], tag
        assert list(g.build_rounds) == [int(r) for r in w.build_rounds], tag
        np.testing.assert_allclose(g.loss, float(w.loss), rtol=1e-5,
                                   err_msg=tag)
        ledger = {p: int(v) for p, v in w.evals_by_phase.items()}
        if g.evals_by_phase != ledger:
            _same_bits(g, BanditPAM(K, seed=seeds[i], device="cpu",
                                    **kw).fit(Xs[i]), tag)
            single = JBanditPAM(K, seed=seeds[i], backend="jnp",
                                **kw).fit(Xs[i])
            assert ledger == {p: int(v) for p, v in
                              single.evals_by_phase.items()}, tag
            assert g.evals_by_phase.keys() == ledger.keys(), tag
            assert all(abs(v - ledger[p]) <= 10 * RING["batch_size"]
                       for p, v in g.evals_by_phase.items()), tag
        assert g.cached_evals > 0, tag


def single_rounds(monkeypatch, backend, fit):
    """``fit()`` (a single PIC fit) and its rounds by phase: its ring
    accesses (one a round), the BUILD ones counted by its BUILD
    statistics calls on ``backend`` (a stats backend class)."""
    calls = {"all": 0, "build": 0}

    def spy(orig, key):
        def counted(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)
        return counted
    monkeypatch.setattr(banditpam, "search_read_or_write",
                        spy(banditpam.search_read_or_write, "all"))
    monkeypatch.setattr(backend, "build_stats_from_d",
                        spy(backend.build_stats_from_d, "build"))
    res = fit()
    monkeypatch.undo()
    return res, {"build": calls["build"],
                 "swap": calls["all"] - calls["build"]}


@pytest.mark.parametrize("ring", [dict(reuse="pic"), RING],
                         ids=["default", "recycling"])
def test_identical_pic_lanes_read_and_round_like_one_fit(monkeypatch, ring):
    """The ``pic`` twin of ``test_identical_lanes_read_and_round_like_
    one_fit``: L identical lanes stop together, so the batch reads exactly
    what one fit reads and enqueues as many rounds as the single fit's
    statistics calls."""
    X = _batch([650])[0]
    kw = dict(ring, device="cpu")
    single, rounds = single_rounds(
        monkeypatch, engine.TorchStatsBackend,
        lambda: BanditPAM(K, seed=3, **kw).fit(X))
    got = BanditPAM(K, **kw).fit_batch([X] * 4, seeds=[3] * 4)
    assert got.host_reads_by_phase == single.host_reads_by_phase
    assert got.dispatches_by_phase == rounds
    for r in got:
        _same_bits(r, single, "identical lane")


class _KernelEntriesOnCpu(engine.CudaStatsBackend):
    """The ``"cuda"`` backend's wiring through the kernel entry points of
    ``ops``, which take their plain versions for CPU tensors."""

    @staticmethod
    def _ops(t):
        return ops


@pytest.mark.parametrize("baseline", ["none", "leader"])
def test_pic_kernel_backend_wiring_on_the_cpu(monkeypatch, baseline):
    """The PIC batch through the kernel backend's lane methods (the lane
    ring's blocks, the leader's row from a lane's block, the lane
    pairwise and the repair) equals the single fits through its single
    methods; every lane entry point validates its inputs as on the card."""
    monkeypatch.setitem(engine._BACKENDS, "kernels-on-cpu",
                        _KernelEntriesOnCpu())
    Xs = _batch([150, 233, 190], seed0=60)
    kw = dict(RING, baseline=baseline, backend="kernels-on-cpu",
              device="cpu")
    got = BanditPAM(K, **kw).fit_batch(Xs, seeds=[1, 2, 3])
    for i, (X, s) in enumerate(zip(Xs, [1, 2, 3])):
        _same_bits(got[i], BanditPAM(K, seed=s, **kw).fit(X),
                   f"fit {i} ({baseline})")
