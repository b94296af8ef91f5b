"""The port's kernel plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and against
both packages' oracles, plus the engine's medoid cache and loss.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: rtol 1e-5 and atol 1e-5·max|d| for distances; the statistics
sum B terms of size up to max|d| (Σg) or max|d|² (Σg², Σg·g_lead), so
their atol carries a factor B and the matching power of max|d|.  Both
are float32 summation-order noise between XLA's and PyTorch's CPU
kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops, ref

METRICS = ["l2", "l2sq", "l1", "cosine"]
B = 100


def _data(m, r, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _f64_pairwise(x, y, metric):
    """The distances in float64 with numpy, from the definitions."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    if metric == "l1":
        return np.abs(x[:, None, :] - y[None, :, :]).sum(-1)
    if metric == "cosine":
        xn = x / np.sqrt((x * x).sum(-1))[:, None]
        yn = y / np.sqrt((y * y).sum(-1))[:, None]
        return 1.0 - xn @ yn.T
    sq = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return np.sqrt(sq) if metric == "l2" else sq


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(130, 100, 17), (64, 300, 129),
                                   (7, 5, 3)])
def test_pairwise_plain_matches_jax_kernel(metric, shape):
    m, r, d = shape
    x, y = _data(m, r, d)
    # Each package gets its own copy of the inputs.
    got = ops.pairwise_distance(torch.tensor(x), torch.tensor(y),
                                metric).numpy()
    want = np.asarray(jops.pairwise_distance(jnp.array(x), jnp.array(y),
                                             metric, interpret=True))
    atol = 1e-5 * np.abs(want).max()
    # Both sides against float64 first, so that a difference names the
    # side that left float32 accuracy.
    exact = _f64_pairwise(x, y, metric)
    _close(got, exact, atol)
    _close(want, exact, atol)
    _close(got, want, atol)
    _close(got, np.asarray(jref.pairwise_ref(jnp.asarray(x), jnp.asarray(y),
                                             metric)), atol)
    _close(got, ref.pairwise_ref(_t(x), _t(y), metric).numpy(), atol)


@pytest.mark.parametrize("metric", ["l2", "l2sq", "cosine"])
@pytest.mark.parametrize("state", ["set_float32_matmul_precision", "mkldnn"])
def test_plain_distances_stay_float32_under_a_reduced_matmul_precision(
        state, metric):
    """ROADMAP C3: a process-wide float32 matmul precision below full
    float32 (``medium``, or oneDNN's ``bf16`` fpmath, which a CPU with
    AMX-BF16 honours) must not reach the port's plain distances, which
    pin IEEE float32 themselves; held to float64 as
    test_pairwise_plain_matches_jax_kernel holds them."""
    from repro_torch.core.distances import pairwise
    mm = torch.backends.mkldnn.matmul
    saved = (torch.get_float32_matmul_precision(), mm.fp32_precision)
    try:
        if state == "mkldnn":
            mm.fp32_precision = "bf16"
        else:
            torch.set_float32_matmul_precision("medium")
        x, y = _data(130, 100, 17)
        exact = _f64_pairwise(x, y, metric)
        atol = 1e-5 * np.abs(exact).max()
        _close(ops.pairwise_distance(_t(x), _t(y), metric).numpy(), exact,
               atol)
        if state == "mkldnn":
            mm.fp32_precision = "bf16"
        else:
            torch.set_float32_matmul_precision("medium")
        _close(pairwise(_t(x), _t(y), metric=metric).numpy(), exact, atol)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        mm.fp32_precision = saved[1]


def _build_inputs(m, d, seed):
    x, y = _data(m, B, d, seed)
    rng = np.random.default_rng(seed + 1)
    dn = (rng.uniform(0.5, 3.0, B) * np.sqrt(d)).astype(np.float32)
    dn[rng.choice(B, 17, replace=False)] = np.inf      # first-assignment refs
    w = np.ones(B, np.float32)
    w[rng.choice(B, 9, replace=False)] = 0.0           # padded slots
    lg = rng.standard_normal(B).astype(np.float32)
    return x, y, dn, w, lg


@pytest.mark.parametrize("metric", METRICS)
def test_build_g_plain_matches_jax_kernel(metric):
    x, y, dn, w, lg = _build_inputs(130, 33, seed=3)
    got = [a.numpy() for a in ops.build_g_stats(
        _t(x), _t(y), _t(dn), _t(w), _t(lg), metric=metric)]
    want = [np.asarray(a) for a in jops.build_g_stats(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(dn), jnp.asarray(w),
        jnp.asarray(lg), metric=metric, interpret=True)]
    dmax = float(ref.pairwise_ref(_t(x), _t(y), metric).abs().max())
    atols = (1e-5 * dmax * B, 1e-5 * dmax ** 2 * B,
             1e-5 * dmax * np.abs(lg).max() * B)
    for g, wv, a in zip(got, want, atols):
        _close(g, wv, a)
    # the two-output oracles of both packages
    osum, osq = ref.build_g_ref(_t(x), _t(y), _t(dn), _t(w), metric)
    _close(got[0], osum.numpy(), atols[0])
    _close(got[1], osq.numpy(), atols[1])
    jsum, _ = jref.build_g_ref(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(dn), jnp.asarray(w), metric)
    _close(got[0], np.asarray(jsum), atols[0])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [3, 5])
def test_swap_g_plain_matches_jax_kernel(metric, k):
    x, y = _data(130, B, 33, seed=5)
    rng = np.random.default_rng(k)
    d1 = (rng.uniform(0.0, 2.0, B) * 6).astype(np.float32)
    d2 = d1 + (rng.uniform(0.0, 2.0, B) * 6).astype(np.float32)
    a = rng.integers(0, k, B).astype(np.int32)
    w = np.ones(B, np.float32)
    w[-11:] = 0.0
    lg = rng.standard_normal(B).astype(np.float32)
    got = [t.numpy() for t in ops.swap_g_stats(
        _t(x), _t(y), _t(d1), _t(d2), _t(a), _t(w), k, _t(lg), metric=metric)]
    want = [np.asarray(t) for t in jops.swap_g_stats(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(a), jnp.asarray(w), k, jnp.asarray(lg), metric=metric,
        interpret=True)]
    dmax = max(float(ref.pairwise_ref(_t(x), _t(y), metric).abs().max()),
               float(d2.max()))
    atols = (1e-5 * dmax * B, 1e-5 * dmax ** 2 * B,
             1e-5 * dmax * np.abs(lg).max() * B)
    for g, wv, at in zip(got, want, atols):
        assert g.shape == (k, 130)
        _close(g, wv, at)
    osum, osq = ref.swap_g_ref(_t(x), _t(y), _t(d1), _t(d2), _t(a), _t(w), k,
                               metric)
    _close(got[0], osum.numpy(), atols[0])
    _close(got[1], osq.numpy(), atols[1])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [3, 5])
def test_top2_plain_matches_jax_kernel(metric, k):
    x, med = _data(650, k, 33, seed=7)
    med[-1] = med[0]                       # duplicate medoid rows: d2 == d1
    got = [t.numpy() for t in ops.stream_top2(_t(x), _t(med), metric=metric)]
    want = [np.asarray(t) for t in jops.stream_top2(
        jnp.asarray(x), jnp.asarray(med), metric=metric, interpret=True)]
    atol = 1e-5 * float(np.abs(want[1]).max())
    _close(got[0], want[0], atol)
    _close(got[1], want[1], atol)
    assert got[2].dtype == np.int32
    np.testing.assert_array_equal(got[2], want[2])
    # The tie rule: rows nearest to the duplicated medoid take index 0,
    # and their runner-up is the duplicate itself.
    tie = got[2] == 0
    assert tie.any()
    np.testing.assert_array_equal(got[1][tie], got[0][tie])
    o1, o2, oa = ref.top2_ref(_t(x), _t(med), metric)
    _close(got[0], o1.numpy(), atol)
    _close(got[1], o2.numpy(), atol)
    np.testing.assert_array_equal(got[2], oa.numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_top2_plain_matches_jax_kernel_past_one_lane_pad(metric):
    """k = 130: the JAX kernel pads the medoids to 256 lanes and masks
    126 of them; two copies of one row sit at columns 0 and 129, on either
    side of the first 128 lanes, near data row 0 (not on it: an l2
    distance of 0 would be sqrt's cancellation noise)."""
    x, med = _data(300, 130, 33, seed=11)
    med[0] = med[129] = x[0] + 0.1 * med[0]
    got = [t.numpy() for t in ops.stream_top2(_t(x), _t(med), metric=metric)]
    want = [np.asarray(t) for t in jops.stream_top2(
        jnp.asarray(x), jnp.asarray(med), metric=metric, interpret=True)]
    atol = 1e-5 * float(np.abs(want[1]).max())
    _close(got[0], want[0], atol)
    _close(got[1], want[1], atol)
    np.testing.assert_array_equal(got[2], want[2])
    assert not (got[2] == 129).any()
    tie = got[2] == 0
    assert tie[0]
    np.testing.assert_array_equal(got[1][tie], got[0][tie])


def test_top2_single_medoid_has_infinite_runner_up():
    x, med = _data(40, 1, 8, seed=2)
    d1, d2, a = ops.stream_top2(_t(x), _t(med), metric="l2")
    assert torch.isinf(d2).all() and (a == 0).all()


@pytest.mark.parametrize("n", [300, 650])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_medoid_cache_and_loss_match_jax_engine(n, metric):
    """Past the 512-row tile (n=650) and with B not dividing n."""
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, 24)).astype(np.float32)
    meds = rng.choice(n, 5, replace=False).astype(np.int32)
    want = [np.asarray(t) for t in jengine.medoid_cache(
        jnp.asarray(X), jnp.asarray(meds), metric=metric)]
    got = [t.numpy() for t in tengine.medoid_cache(
        _t(X), torch.as_tensor(meds, dtype=torch.int64), metric=metric)]
    dmax = float(np.abs(want[1]).max())
    atol = 1e-5 * dmax
    if metric == "l2":
        # The medoid rows' own distance is 0 up to the l2sq summation
        # noise (worst case d·2^-24 relative over d features), which the
        # square root lifts to sqrt(d·2^-24)·max|d|.
        atol += np.sqrt(X.shape[1] * 2.0 ** -24) * dmax
    _close(got[0], want[0], atol)
    _close(got[1], want[1], atol)
    np.testing.assert_array_equal(got[2], want[2])
    jl = float(jengine.total_loss(jnp.asarray(X), jnp.asarray(meds),
                                  metric=metric))
    tl = tengine.total_loss(_t(X), torch.as_tensor(meds, dtype=torch.int64),
                            metric=metric)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)


def test_wrappers_validate_inputs():
    x, y = _data(10, 6, 4)
    with pytest.raises(ValueError, match="float32"):
        ops.pairwise_distance(_t(x).double(), _t(y).double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.pairwise_distance(_t(x).T, _t(y).T)
    with pytest.raises(ValueError, match="no kernel"):
        ops.pairwise_distance(_t(x), _t(y), "hamming")
    with pytest.raises(ValueError, match="int32"):
        ops.swap_g_stats(_t(x), _t(y), torch.ones(6), torch.ones(6),
                         torch.zeros(6, dtype=torch.int64), torch.ones(6), 2)
    with pytest.raises(ValueError, match=r"\[B\]"):
        ops.build_g_stats(_t(x), _t(y), torch.ones(5), torch.ones(6))


@pytest.mark.parametrize("kernel", ["build_g", "swap_g", "pairwise",
                                    "swap_g_from_cache", "stream_build_g",
                                    "stream_swap_g"])
def test_plain_versions_take_the_run_flag(kernel):
    """The run flag (0: a round enqueued after its search stopped, or a
    search that needs no exact fallback) reaches the plain versions too,
    which compute all the same: the search discards a masked result
    whatever computed it.  A flag that is not one int32 element is
    refused."""
    x, y = _data(30, 6, 4)
    ones = torch.ones(6)
    a0 = torch.zeros(6, dtype=torch.int32)
    if kernel == "build_g":
        def call(run):
            return ops.build_g_stats(_t(x), _t(y), ones, ones, run=run)
    elif kernel == "swap_g":
        def call(run):
            return ops.swap_g_stats(_t(x), _t(y), ones, 2 * ones, a0, ones,
                                    2, run=run)
    elif kernel == "pairwise":
        def call(run):
            return (ops.pairwise_distance(_t(x), _t(y), run=run),)
    elif kernel == "swap_g_from_cache":
        dxy = torch.from_numpy(np.abs(_data(6, 30, 6)[1]))

        def call(run):
            return ops.swap_g_stats_cached(dxy, ones, 2 * ones, a0, ones, 2,
                                           run=run)
    elif kernel == "stream_build_g":
        def call(run):
            return ops.stream_build_g_stats(_t(x), _t(y), ones, run=run)
    else:
        def call(run):
            return ops.stream_swap_g_stats(_t(x), _t(y), ones, 2 * ones, a0,
                                           k=2, run=run)
    want = call(None)
    for flag in (0, 1):
        for g, w in zip(call(torch.tensor([flag], dtype=torch.int32)), want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="run"):
        call(torch.tensor([1]))


def test_plain_pairwise_into_a_ring_slot_keeps_it_at_flag_0():
    """``pairwise_distance(out=...)`` writes into a column slice of a ring
    (any row stride), as a PIC round's new block does; at run flag 0 the
    slice keeps its values, as the kernel leaves it unwritten; and the
    torch stats backend honours the same contract."""
    x, y = _data(30, 6, 4)
    want = ops.pairwise_distance(_t(x), _t(y))
    for pairwise in (lambda o, r: ops.pairwise_distance(_t(x), _t(y),
                                                        out=o, run=r),
                     lambda o, r: tengine.TorchStatsBackend().pairwise(
                         _t(x), _t(y), metric="l2", out=o, run=r)):
        ring = torch.full((30, 4 * 6), -1.0)
        slot = ring[:, 6:12]
        pairwise(slot, torch.tensor([0], dtype=torch.int32))
        assert bool((ring == -1.0).all())
        pairwise(slot, torch.tensor([1], dtype=torch.int32))
        assert torch.equal(slot, want)
        assert bool((ring[:, :6] == -1.0).all())
        assert bool((ring[:, 12:] == -1.0).all())
    with pytest.raises(ValueError, match="out"):
        ops.pairwise_distance(_t(x), _t(y), out=torch.zeros(30, 5))


def test_plain_path_never_counts_launches():
    ops.reset_launch_counts()
    x, y = _data(20, 6, 4)
    ops.pairwise_distance(_t(x), _t(y))
    ops.stream_top2(_t(x), _t(y))
    ones = torch.ones(6)
    ops.stream_build_g_stats(_t(x), _t(y), ones)
    ops.stream_swap_g_stats(_t(x), _t(y), ones, ones,
                            torch.zeros(6, dtype=torch.int32), k=2)
    ops.swap_g_stats_cached(torch.ones(20, 6), ones, ones,
                            torch.zeros(6, dtype=torch.int32), ones, 2)
    x3, y3 = torch.from_numpy(x)[None], torch.from_numpy(y)[None]
    lane = torch.ones(1, 6)
    ops.build_g_lanes_stats(x3, y3, lane, lane)
    ops.swap_g_lanes_stats(x3, y3, lane, lane,
                           torch.zeros(1, 6, dtype=torch.int32), lane, 2)
    ops.stream_top2_lanes(x3, y3)
    ops.pairwise_lanes(x3, y3)
    ops.swap_g_from_cache_lanes_stats(torch.ones(1, 20, 6), lane, lane,
                                      torch.zeros(1, 6, dtype=torch.int32),
                                      lane, 2)
    assert ops.launch_counts() == {"pairwise": 0, "build_g": 0, "swap_g": 0,
                                   "swap_g_from_cache": 0, "top2": 0,
                                   "stream_build_g": 0, "stream_swap_g": 0,
                                   "build_g_lanes": 0, "swap_g_lanes": 0,
                                   "top2_lanes": 0, "pairwise_lanes": 0,
                                   "swap_g_from_cache_lanes": 0}
