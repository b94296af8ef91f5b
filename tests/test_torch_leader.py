"""The leader baseline (``baseline="leader"``) of the port's search held
against the JAX package's, apart from the batch statistics' last bits.

The differenced kill rule reads ``σ_d`` from ``Σg² − 2·Σg·g_lead +
Σg_lead²`` over one batch: a difference of sums of size ~B·max|g|² whose
float32 rounding depends on the summation order.  Two implementations
that sum in different orders can move an arm whose differenced margin
sits within that noise of the ``LEAD_TIE_REL`` threshold by one round,
and so the ledger by a few arm-rounds.  The JAX package does so against
itself (``test_reference_leader_ledger_depends_on_compilation``).
These tests split the port's leader path into the parts that can be
held exactly:

* the search, given bit-identical batch statistics, pays the JAX
  search's ledger exactly and picks the same arm after the same rounds
  (the JAX backend computes the statistics for both, op by op);
* the port's cross-sums agree with the JAX backend's to float32
  rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BanditPAM as JBanditPAM
from repro.core import adaptive as jadaptive
from repro.core import datasets as jdatasets
from repro.core import engine as jengine
from repro_torch import convert
from repro_torch.core import BanditPAM, adaptive, engine
from test_torch_banditpam import FIXTURES, jax_layouts
from torch_threads import one_intra_op_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _searches(n, k, metric, X, bperms, sperm):
    """Run every BUILD search of a leader fit and its first SWAP search
    through both packages' ``adaptive_search`` with the JAX backend's
    statistics; returns (best, rounds, n_evals) per search and package."""
    jb = jengine.get_stats_backend("jnp")
    data = jnp.asarray(X)
    out = {"jax": [], "port": []}

    def both(n_arms, jstats, count_j, count_t, active, perm, delta):
        def tstats(ref_idx, w, lead):
            return tuple(_t(a) for a in jstats(
                jnp.asarray(ref_idx.numpy()), jnp.asarray(w.numpy()),
                0 if lead is None else int(lead), 0))
        want = jadaptive.adaptive_search(
            jax.random.PRNGKey(0), stats_fn=jstats, exact_fn=None,
            n_arms=n_arms, n_ref=n, batch_size=100,
            active_init=jnp.asarray(active), count_fn=count_j,
            perm=jnp.asarray(perm, jnp.int32), baseline="leader")
        got = adaptive.adaptive_search(
            stats_fn=tstats, n_arms=n_arms, n_ref=n, batch_size=100,
            log_term=adaptive.log_term_f32(delta, "cpu"),
            active_init=_t(active), count_fn=count_t,
            layout=adaptive.cyclic_layout(_t(perm).long(), n, 100),
            baseline="leader")
        out["jax"].append((int(want.best), int(want.rounds),
                           int(want.n_evals)))
        out["port"].append((got.best, got.rounds, got.n_evals))
        return got.best

    with jax.disable_jit():
        dnear = jnp.full((n,), jnp.inf, jnp.float32)
        mask = np.zeros(n, bool)
        for i in range(k):
            def jstats(ref_idx, w, lead, rnd, dnear=dnear):
                return jb.build_stats(data, ref_idx, dnear[ref_idx], w, lead,
                                      metric=metric)
            m = both(n, jstats, None, adaptive.default_count, ~mask,
                     bperms[i], 1.0 / (1000.0 * n))
            mask[m] = True
            dnear = jnp.minimum(dnear, jb.pairwise(data[m:m + 1], data,
                                                   metric=metric)[0])
        meds = jnp.asarray(np.flatnonzero(mask).astype(np.int32))
        d1, d2, a = jengine.medoid_cache(data, meds, metric=metric)

        def jstats(ref_idx, w, lead, rnd):
            return jb.swap_stats(data, ref_idx, d1[ref_idx], d2[ref_idx],
                                 a[ref_idx], w, k, lead, metric=metric)

        def count_j(act):
            return jnp.sum(jnp.any(act.reshape(k, n), axis=0)
                           ).astype(jnp.uint32)

        def count_t(act):
            return torch.sum(torch.any(act.view(k, n), dim=0),
                             dtype=torch.int64)
        both(k * n, jstats, count_j, count_t, np.tile(~mask, k), sperm,
             1.0 / (1000.0 * k * n))
    return out


@pytest.mark.parametrize("n,k,metric", FIXTURES)
def test_leader_search_matches_jax_on_equal_statistics(n, k, metric):
    X = jdatasets.mnist_like(n, seed=1)
    bperms, sperms = jax_layouts(0, n, k)
    out = _searches(n, k, metric, X, bperms, sperms[0])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_leader_cross_sums_match_jax_backend(metric):
    """The torch backend's (Σg, Σg², Σg·g_lead) with a leader, BUILD and
    SWAP, against the JAX backend's on the same batch.  The batch is drawn
    from the upper half of the rows and the leaders and the compared arms
    from the lower half: an l2 self-distance is sqrt of a rounding
    residue (~1e-3 here), which differs between the two packages.  The
    SWAP arms whose candidate is a medoid, never active in a search, are
    left out: their statistics are 0 up to cancellation noise."""
    n, k = 400, 3
    X = jdatasets.mnist_like(n, seed=3)
    gen = np.random.default_rng(2)
    ref = gen.integers(n // 2, n, 100)
    lo = slice(0, n // 2)
    w = np.ones(100, np.float32)
    w[-9:] = 0.0
    dnear = gen.uniform(1, 5, n).astype(np.float32)
    jb = jengine.get_stats_backend("jnp")
    tb = engine.get_stats_backend("torch")
    data = jnp.asarray(X)
    want = jb.build_stats(data, jnp.asarray(ref), jnp.asarray(dnear[ref]),
                          jnp.asarray(w), 17, metric=metric)
    got = tb.build_stats(_t(X), _t(ref), _t(dnear[ref]), _t(w),
                         torch.tensor(17), metric=metric)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g[lo], _t(wv)[lo], rtol=1e-5, atol=1e-3)
    meds = np.array([3, 50, 120])
    d1, d2, a = jengine.medoid_cache(data, jnp.asarray(meds, jnp.int32),
                                     metric=metric)
    d1, d2, a = (np.asarray(v)[ref] for v in (d1, d2, a))
    lead = 2 * n + 77                              # medoid 2, candidate 77
    want = jb.swap_stats(data, jnp.asarray(ref), jnp.asarray(d1),
                         jnp.asarray(d2), jnp.asarray(a), jnp.asarray(w), k,
                         lead, metric=metric)
    got = tb.swap_stats(_t(X), _t(ref), _t(d1), _t(d2), _t(a).long(), _t(w),
                        k, torch.tensor(lead), metric=metric)
    cand = np.setdiff1d(np.arange(n // 2), meds)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g.view(k, n)[:, cand],
                                   _t(wv).view(k, n)[:, cand],
                                   rtol=1e-5, atol=1e-3)


def test_reference_leader_ledger_depends_on_compilation():
    """At (650, 5, l2) the JAX package's jitted leader fit and the same
    fit op by op (``jax.disable_jit()``) pick the same medoids after the
    same rounds but pay different BUILD ledgers; the port's, on the
    JAX draws, lies within a few arm-rounds of both."""
    n, k = 650, 5
    X = jdatasets.mnist_like(n, seed=1)
    jit = JBanditPAM(k, seed=0, backend="jnp", baseline="leader").fit(X)
    with jax.disable_jit():
        eager = JBanditPAM(k, seed=0, backend="jnp", baseline="leader").fit(X)
    port = BanditPAM(k, device="cpu", baseline="leader").fit(
        X, layouts=convert.layouts_from_reference(*jax_layouts(0, n, k)))
    for f in (eager, port):
        assert np.asarray(f.medoids).tolist() == np.asarray(jit.medoids).tolist()
        assert list(f.build_rounds) == list(jit.build_rounds)
        assert f.evals_by_phase["swap"] == jit.evals_by_phase["swap"]
    assert eager.evals_by_phase["build"] != jit.evals_by_phase["build"]
    for f in (jit, eager):
        assert abs(port.evals_by_phase["build"]
                   - f.evals_by_phase["build"]) <= 4 * 100


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_device_leader_gives_the_int_leaders_statistics(backend,
                                                       monkeypatch):
    """The port's backends take the leader as a 0-d int64 device index,
    the JAX backend as an int: every leader statistic (BUILD and SWAP,
    fresh and from a distance block) agrees with the JAX backend's at
    the same leader to float32 rounding.  The cuda backend runs here on
    the CPU through the kernels' plain versions (its device check
    lifted).  The batch, the leaders and the compared arms are split as
    in ``test_leader_cross_sums_match_jax_backend``; the block forms get
    one distance block, the port's."""
    from repro_torch.kernels import ops
    if backend == "cuda":
        monkeypatch.setattr(engine.CudaStatsBackend, "_ops",
                            staticmethod(lambda t: ops))
    be = engine.get_stats_backend(backend)
    jb = jengine.get_stats_backend("jnp")
    n, k = 240, 3
    Xn = jdatasets.mnist_like(n, seed=4, d=40)
    X, data = _t(Xn), jnp.asarray(Xn)
    gen = np.random.default_rng(5)
    ref = gen.integers(n // 2, n, 100)
    w = np.ones(100, np.float32)
    w[-9:] = 0.0
    dnear = gen.uniform(1, 5, n).astype(np.float32)[ref]
    meds = np.array([3, 50, 120])
    d1, d2, a = (np.asarray(v)[ref] for v in jengine.medoid_cache(
        data, jnp.asarray(meds, jnp.int32), metric="l2"))
    dxy = ops.pairwise_distance(X, X[_t(ref)].contiguous(), "l2")
    J = {name: jnp.asarray(v) for name, v in
         dict(ref=ref, w=w, dnear=dnear, d1=d1, d2=d2, a=a,
              dxy=dxy.numpy()).items()}
    T = {name: _t(v) for name, v in
         dict(ref=ref, w=w, dnear=dnear, d1=d1, d2=d2,
              a=a.astype(np.int32), dxy=dxy).items()}
    build = [
        lambda b, v, L: b.build_stats(X if b is be else data, v["ref"],
                                      v["dnear"], v["w"], L, metric="l2"),
        lambda b, v, L: b.build_stats_from_d(v["dxy"], v["dnear"], v["w"],
                                             L)]
    swap = [
        lambda b, v, L: b.swap_stats(X if b is be else data, v["ref"],
                                     v["d1"], v["d2"], v["a"], v["w"], k, L,
                                     metric="l2"),
        lambda b, v, L: b.swap_stats_from_d(v["dxy"], v["d1"], v["d2"],
                                            v["a"], v["w"], k, L)]
    cand = np.setdiff1d(np.arange(n // 2), meds)
    for lead, calls, arms in ((17, build, np.arange(n // 2)),
                              (2 * n + 77, swap,
                               (np.arange(k)[:, None] * n + cand).ravel())):
        for call in calls:
            got = call(be, T, torch.tensor(lead))
            want = call(jb, J, lead)
            for g, wv in zip(got, want):
                torch.testing.assert_close(g[arms], _t(wv)[arms],
                                           rtol=1e-5, atol=1e-3)
