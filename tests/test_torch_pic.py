"""The BanditPAM++ reuse engine of the port (``reuse="pic"``, the warm
block ``cache_cols``, the carried-moment repair) held against the JAX
package on the CPU.

The JAX fit's one fixed reference permutation
(``jax.random.permutation(ckey, n)``, ``ckey`` from the chain's first
split) is replayed through ``convert.layouts_from_reference(fixed_perm=
...)``, so both packages walk identical rounds.  Medoids, swap history,
``build_rounds`` and every ``evals_by_phase`` entry (fresh and cached)
must be equal, and the loss agrees to rtol 1e-5 (the float32 summation
order of the final loss sum).  The l1 fixture runs in
``tests/test_torch_pic_l1.py``, so the matrix is spread over the test
workers.

Unit tests hold the parts: the plain ``swap_g_from_cache`` against the
Pallas kernel (interpret mode), the port's ``_carry_delta`` against the
JAX one on the same inputs, and the ring's bookkeeping (served blocks,
``hw``, ``fresh_pos``) against ``repro.core.pic_cache`` over a round
sequence that recycles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BanditPAM as JBanditPAM
from repro.core import banditpam as jbanditpam
from repro.core import datasets as jdatasets
from repro.core import engine as jengine
from repro.core import pic_cache as jpic
from repro.core.banditpam import _batch_rng_chains
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.api import KMedoids
from repro_torch.core import BanditPAM, banditpam, engine, pic_cache, rng
from repro_torch.kernels import ops
from test_torch_banditpam import FIXTURES
from torch_threads import one_intra_op_thread  # noqa: F401

B = 100

MODES = {
    "pic": {"reuse": "pic"},
    "pic_w100": {"reuse": "pic", "cache_width": 100},
    "pic_w200": {"reuse": "pic", "cache_width": 200},
    # the warm block clamped to the ring (cache_cols > cache_width)
    "pic_warm": {"reuse": "pic", "cache_width": 200, "cache_cols": 400},
    "warm": {"reuse": "none", "cache_cols": 300},
    "pic_leader": {"reuse": "pic", "baseline": "leader"},
    "pic_stepped": {"reuse": "pic", "fused": False},
}


def jax_fixed_perm(seed: int, n: int, k: int) -> np.ndarray:
    """The JAX fit's fixed reference permutation of a cached fit."""
    ckey = _batch_rng_chains(jnp.asarray([seed]), k=k, T=4 * k + 10)[0][0]
    return np.asarray(jax.random.permutation(ckey, n))


def _t(a):
    return torch.from_numpy(np.array(a))


def check_mode_against_jax(n, k, metric, mode):
    kw = MODES[mode]
    X = jdatasets.mnist_like(n, seed=1)
    want = JBanditPAM(k, metric=metric, seed=0, backend="jnp", **kw).fit(X)
    got = BanditPAM(k, metric=metric, device="cpu", **kw).fit(
        X, layouts=convert.layouts_from_reference(
            fixed_perm=jax_fixed_perm(0, n, k)))
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    assert got.build_rounds == want.build_rounds
    assert (got.n_swaps, got.converged) == (want.n_swaps, want.converged)
    assert got.evals_by_phase == want.evals_by_phase
    assert got.distance_evals == want.distance_evals
    assert got.cached_evals == want.cached_evals
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
    for (_, _, lg), (_, _, lw) in zip(got.swap_history, want.swap_history):
        assert abs(lg - lw) <= 1e-5 * abs(lw)
    return got


@pytest.mark.parametrize("n,k,metric,mode",
                         [f + (m,) for f in FIXTURES if f[2] == "l2"
                          for m in MODES])
def test_cached_fit_modes_match_jax_reference(n, k, metric, mode):
    got = check_mode_against_jax(n, k, metric, mode)
    ph = got.evals_by_phase
    if mode == "warm":
        assert ph.keys() == {"cache_warm", "build", "swap"}
    else:
        assert {"build", "build_cached", "swap", "swap_cached"} <= ph.keys()
        assert ph["swap_cached"] > 0


def test_default_ring_runs_the_carried_repair(monkeypatch):
    """With a ring that holds the whole permutation the carried moments
    seed every SWAP search after the first, through ``_carry_delta``."""
    calls = []
    orig = banditpam._carry_delta

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls.append(int(out[2]))
        return out
    monkeypatch.setattr(banditpam, "_carry_delta", spy)
    n, k = 300, 3
    got = check_mode_against_jax(n, k, "l2", "pic")
    assert len(calls) == got.n_swaps + int(got.converged) - 1 > 0
    assert all(0 < c <= n for c in calls)


def test_recycled_ring_starts_cold(monkeypatch):
    """A ring narrower than the permutation recycles rounds, so the
    carried prefix is never resident and no repair runs."""
    monkeypatch.setattr(banditpam, "_carry_delta", None)
    check_mode_against_jax(300, 3, "l2", "pic_w100")


# ---------------------------------------------------------------------------
# The kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [B, jops.CACHE_B_MAX + 300])
@pytest.mark.parametrize("k", [1, 4])
def test_swap_g_from_cache_plain_matches_jax_kernel(b, k):
    m = 130
    rng_ = np.random.default_rng(b + k)
    dxy = rng_.uniform(0.0, 12.0, (m, b)).astype(np.float32)
    d1 = rng_.uniform(0.0, 6.0, b).astype(np.float32)
    d2 = d1 + rng_.uniform(0.0, 6.0, b).astype(np.float32)
    a = rng_.integers(0, k, b).astype(np.int32)
    w = (rng_.uniform(size=b) > 0.1).astype(np.float32)
    lg = rng_.standard_normal(b).astype(np.float32)
    got = [t.numpy() for t in ops.swap_g_stats_cached(
        _t(dxy), _t(d1), _t(d2), _t(a), _t(w), k, _t(lg))]
    want = [np.asarray(t) for t in jops.swap_g_stats_cached(
        jnp.asarray(dxy), jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(a),
        jnp.asarray(w), k, jnp.asarray(lg), interpret=True)]
    dmax = 12.0
    atols = (1e-5 * dmax * b, 1e-5 * dmax ** 2 * b,
             1e-5 * dmax * np.abs(lg).max() * b)
    for g, wv, at in zip(got, want, atols):
        assert g.shape == (k, m)
        np.testing.assert_allclose(g, wv, rtol=1e-5, atol=at)


def test_swap_g_from_cache_reads_a_ring_slice_in_place():
    """A column slice of the ring (row stride W·B) gives the statistics
    of its contiguous copy; a block whose columns are not adjacent is
    refused."""
    gen = torch.Generator().manual_seed(0)
    ring = torch.rand((70, 5 * B), generator=gen) * 10
    view = ring[:, 2 * B:3 * B]
    d1 = torch.rand(B, generator=gen) * 5
    d2 = d1 + torch.rand(B, generator=gen) * 5
    a = torch.randint(0, 3, (B,), generator=gen, dtype=torch.int32)
    w = torch.ones(B)
    got = ops.swap_g_stats_cached(view, d1, d2, a, w, 3)
    want = ops.swap_g_stats_cached(view.contiguous(), d1, d2, a, w, 3)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert torch.equal(got[2], torch.zeros((3, 70)))
    with pytest.raises(ValueError, match="adjacent"):
        ops.swap_g_stats_cached(ring.T[:B], d1[:70], d2[:70], a[:70] * 0,
                                w[:70], 3)
    with pytest.raises(ValueError, match="int32"):
        ops.swap_g_stats_cached(view, d1, d2, a.long(), w, 3)
    with pytest.raises(ValueError, match=r"\[B\]"):
        ops.swap_g_stats_cached(view, d1[:-1], d2, a, w, 3)
    with pytest.raises(ValueError, match="k must be"):
        ops.swap_g_stats_cached(view, d1, d2, a, w, 0)


# ---------------------------------------------------------------------------
# The carried-moment repair against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,n_prefix", [("l2", 400), ("l1", 600),
                                             ("l2", 0)])
def test_carry_delta_matches_jax(metric, n_prefix):
    n, k, W = 650, 4, 7
    X = jdatasets.mnist_like(n, seed=3)
    perm = np.random.default_rng(1).permutation(n)
    width = W * B
    pidx = np.tile(perm, 2)[:width]
    pw = (np.arange(width) < n).astype(np.float32)
    data = jnp.asarray(X)
    cols = jengine.pairwise(data, data[jnp.asarray(pidx)], metric=metric)
    old = jnp.asarray([3, 100, 250, 400], jnp.int32)
    new = old.at[1].set(511)
    d1o, d2o, ao = jengine.medoid_cache(data, old, metric=metric)
    d1n, d2n, an = jengine.medoid_cache(data, new, metric=metric)
    g = np.random.default_rng(2)
    sums = g.standard_normal(k * n).astype(np.float32) * 50
    sqsums = np.abs(g.standard_normal(k * n)).astype(np.float32) * 500
    want = jbanditpam._carry_delta(
        cols, jnp.asarray(pidx), jnp.asarray(pw), jnp.int32(n_prefix),
        d1o, d2o, ao, d1n, d2n, an, jnp.asarray(sums), jnp.asarray(sqsums),
        k=k, backend="jnp")
    tcast = [_t(v) for v in (cols, pidx, pw, d1o, d2o, ao, d1n, d2n, an)]
    got = banditpam._carry_delta(
        engine.get_stats_backend("torch"), tcast[0], tcast[1], tcast[2],
        n_prefix, *tcast[3:], _t(sums), _t(sqsums), k)
    assert int(got[2]) == int(want[2])
    if n_prefix == 0:
        assert int(got[2]) == 0
        np.testing.assert_array_equal(got[0].numpy(), sums)
    else:
        assert 0 < int(got[2]) < n_prefix
    dmax = float(jnp.max(cols))
    # Σ over ≤ n_prefix changed terms of size ≤ dmax (Σg) and dmax² (Σg²).
    for gv, wv, scale in zip(got[:2], want[:2], (dmax, dmax * dmax)):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-5 * scale * max(n_prefix, 1))


# ---------------------------------------------------------------------------
# The ring's bookkeeping against repro.core.pic_cache
# ---------------------------------------------------------------------------

class _JaxIdBackend:
    """A pairwise whose column j holds the reference's id (feature 0), so
    a served block names the round it came from."""

    def pairwise(self, x, y, *, metric):
        return jnp.zeros((x.shape[0], 1), jnp.float32) + y[:, 0][None, :]


class _TorchIdBackend:
    def pairwise(self, x, y, *, metric, out=None, run=None):
        # The backend contract's out / run: a flag of 0 keeps out.
        dxy = torch.zeros((x.shape[0], 1)) + y[:, 0][None, :]
        if out is None:
            return dxy
        if run is not None:
            dxy = torch.where(run.bool(), dxy, out)
        return out.copy_(dxy)


def test_ring_bookkeeping_matches_jax_over_recycling_rounds():
    n, b, W = 57, 10, 3
    data = np.zeros((n, 2), np.float32)
    data[:, 0] = np.arange(n)
    perm = np.random.default_rng(0).permutation(n)
    idx = np.tile(perm, 2)
    jc = jpic.make_cache(n, b, W)
    tc = pic_cache.make_cache(n, b, W, "cpu")
    jd, td = jnp.asarray(data), _t(data)
    seq = [0, 1, 2, 3, 4, 0, 1, 5, 2, 4, 3, 5, 0, 5]
    served = []
    for rnd in seq:
        ref = idx[rnd * b:(rnd + 1) * b]
        b_eff = min(b, n - rnd * b)
        win = pic_cache._in_window(rnd, tc.hw, W)
        jdxy, jc = jpic.cache_read_or_write(
            _JaxIdBackend(), jd, jnp.asarray(ref), metric="l2",
            batch_size=b, rnd=rnd, b_eff=b_eff, cache=jc)
        # The sharded fit's access a round at a time.
        tdxy = pic_cache.shard_slot_read_write(
            tc.cols, rnd, tc.hw, b,
            lambda: _TorchIdBackend().pairwise(td, td[_t(ref)], metric="l2"))
        pic_cache.cache_advance(tc, rnd, b_eff, W)
        np.testing.assert_array_equal(tdxy.numpy(), np.asarray(jdxy))
        np.testing.assert_array_equal(tdxy[0].numpy(), ref)
        np.testing.assert_array_equal(tc.cols.numpy(), np.asarray(jc.cols))
        assert (tc.hw, tc.fresh_pos) == (int(jc.hw), int(jc.fresh_pos))
        assert pic_cache.carry_valid(tc, b) == bool(jpic.carry_valid(jc, b))
        served.append(win)
    # Both kinds of access happened: window hits and evicted replays.
    assert any(served) and not all(served)
    assert tc.hw == 6 and tc.fresh_pos > 6 * b - 3


def test_search_ring_matches_jax_over_recycling_searches():
    """The single fit's ring access a search at a time
    (``search_read_or_write`` from the search's starting ``hw``, the
    state moved by ``search_advance`` at its end) against the JAX ring a
    round at a time, over searches that serve, write and recycle rounds:
    the same blocks, bytes, ``hw`` and ``fresh_pos``.  Each search is
    followed by rounds enqueued after its stop (run flag 0), which leave
    the ring as it was."""
    n, b, W = 57, 10, 3
    data = np.zeros((n, 2), np.float32)
    data[:, 0] = np.arange(n)
    perm = np.random.default_rng(0).permutation(n)
    idx = np.tile(perm, 2)
    sizes = [min(b, n - r * b) for r in range(6)]
    jc = jpic.make_cache(n, b, W)
    tc = pic_cache.make_cache(n, b, W, "cpu")
    jd, td = jnp.asarray(data), _t(data)
    flag = {v: torch.tensor([v], dtype=torch.int32) for v in (0, 1)}
    kinds = set()
    # (first round, rounds run): BUILD-like from 0, and carried starts.
    for r0, ran in [(0, 2), (0, 5), (1, 1), (0, 6), (2, 3), (0, 1), (5, 1)]:
        hw0 = tc.hw
        for rnd in range(r0, r0 + ran):
            ref = idx[rnd * b:(rnd + 1) * b]
            kinds.add("served" if pic_cache._in_window(rnd, hw0, W)
                      else "new" if rnd >= hw0 else "recycled")
            tdxy = pic_cache.search_read_or_write(
                _TorchIdBackend(), td, _t(ref), metric="l2", batch_size=b,
                rnd=rnd, hw0=hw0, cache=tc, run=flag[1])
            jdxy, jc = jpic.cache_read_or_write(
                _JaxIdBackend(), jd, jnp.asarray(ref), metric="l2",
                batch_size=b, rnd=rnd, b_eff=sizes[rnd], cache=jc)
            np.testing.assert_array_equal(tdxy.numpy(), np.asarray(jdxy))
        cols = tc.cols.clone()
        for rnd in range(r0 + ran, 6):       # past the stop: masked
            pic_cache.search_read_or_write(
                _TorchIdBackend(), td, _t(idx[rnd * b:(rnd + 1) * b]),
                metric="l2", batch_size=b, rnd=rnd, hw0=hw0, cache=tc,
                run=flag[0])
        assert torch.equal(tc.cols, cols)
        pic_cache.search_advance(tc, hw0, r0, r0 + ran, sizes, b)
        np.testing.assert_array_equal(tc.cols.numpy(), np.asarray(jc.cols))
        assert (tc.hw, tc.fresh_pos) == (int(jc.hw), int(jc.fresh_pos))
    assert kinds == {"served", "new", "recycled"}


def test_resolve_cache_rounds_matches_jax():
    for n_rounds, width in [(7, None), (40, None), (7, 100), (7, 250),
                            (7, 10 ** 6), (600, 60000), (600, 3200)]:
        assert (pic_cache.resolve_cache_rounds(n_rounds, B, width)
                == jpic.resolve_cache_rounds(n_rounds, B, width))
    with pytest.raises(ValueError, match="narrower"):
        pic_cache.resolve_cache_rounds(7, B, 50)


# ---------------------------------------------------------------------------
# The knobs, the layouts and the facade
# ---------------------------------------------------------------------------

def test_cache_knob_errors_match_jax():
    X = jdatasets.mnist_like(200, seed=0, d=16)
    with pytest.raises(ValueError, match="permutation"):
        BanditPAM(3, reuse="pic", sampling="replacement", device="cpu")
    with pytest.raises(ValueError, match="narrower"):
        BanditPAM(3, reuse="pic", cache_width=50, device="cpu").fit(X)
    with pytest.raises(ValueError, match="reuse"):
        BanditPAM(3, reuse="all", device="cpu")


def test_replacement_sampling_ignores_the_warm_block():
    X = jdatasets.mnist_like(220, seed=2, d=16)
    a = BanditPAM(3, sampling="replacement", seed=1, device="cpu").fit(X)
    b = BanditPAM(3, sampling="replacement", cache_cols=200, seed=1,
                  device="cpu").fit(X)
    assert a.evals_by_phase == b.evals_by_phase
    assert a.medoids.tolist() == b.medoids.tolist()


def test_seed_layouts_fixed_permutation_is_a_permutation():
    X = jdatasets.mnist_like(260, seed=0, d=16)
    a = BanditPAM(3, reuse="pic", seed=5, device="cpu").fit(X)
    b = BanditPAM(3, reuse="pic", seed=5, device="cpu").fit(X)
    assert a.medoids.tolist() == b.medoids.tolist()
    assert a.evals_by_phase == b.evals_by_phase
    # The fixed permutation comes from the chain's ``ckey``: a
    # permutation of [0, n), the same before or after the searches draw,
    # and for a warm fit (no BUILD searches).
    src = rng.from_seed(0, "cpu", 3)
    fixed = src.fixed_perm(10).tolist()
    assert sorted(fixed) == list(range(10))
    src.build_perm(0, 10)
    assert src.fixed_perm(10).tolist() == fixed
    assert rng.from_seed(0, "cpu", 0).fixed_perm(10).tolist() == fixed


def test_fixed_permutation_layouts_validate():
    with pytest.raises(ValueError, match="permutations"):
        convert.layouts_from_reference(fixed_perm=np.zeros(5, int))
    src = convert.layouts_from_reference(fixed_perm=np.arange(5)[::-1])
    assert src.fixed_perm(5).tolist() == [4, 3, 2, 1, 0]
    with pytest.raises(ValueError, match="has 6"):
        src.fixed_perm(6)
    with pytest.raises(ValueError, match="no build"):
        src.build_perm(0, 5)
    with pytest.raises(ValueError, match="fixed permutation"):
        convert.layouts_from_reference(np.tile(np.arange(5), (2, 1)),
                                       np.tile(np.arange(5), (1, 1))
                                       ).fixed_perm(5)


def test_kmedoids_passes_the_cache_knobs_to_the_fit():
    n, k = 300, 3
    X = jdatasets.mnist_like(n, seed=1)
    lay = convert.layouts_from_reference(fixed_perm=jax_fixed_perm(0, n, k))
    est = KMedoids(k=k, reuse="pic", cache_width=200, cache_cols=400,
                   device="cpu").fit(X, layouts=lay)
    want = JBanditPAM(k, seed=0, backend="jnp", reuse="pic",
                      cache_width=200, cache_cols=400).fit(X)
    assert est.medoids_.tolist() == np.asarray(want.medoids).tolist()
    assert est.report_.evals_by_phase == want.evals_by_phase
    pp = KMedoids(k=k, solver="banditpam_pp", device="cpu").fit(X,
                                                                 layouts=lay)
    jpp = JBanditPAM(k, seed=0, backend="jnp", reuse="pic").fit(X)
    assert pp.medoids_.tolist() == np.asarray(jpp.medoids).tolist()
    assert pp.report_.evals_by_phase == jpp.evals_by_phase
