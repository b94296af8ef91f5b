"""The plain versions of the port's streaming kernels (``stream_build_g``,
``stream_swap_g``) against the JAX package's Pallas streaming kernels in
interpret mode (as tests/test_megakernel.py runs them) and against the
batch kernels' oracles, on the CPU.

The reference set has r = 600 rows, so the walk crosses a 512-column
tile; the inputs carry a non-zero leader row, weight-0 slots and, for
BUILD, both finite and infinite ``dnear``.  Tolerances are those of
``test_torch_kernels.py`` with the batch size B replaced by r: the
statistics sum r terms of size up to max|d| (Σg) or max|d|² (Σg²,
Σg·g_lead), so float32 summation-order noise scales with r.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from torch_threads import one_intra_op_thread  # noqa: F401

METRICS = ["l2", "l2sq", "l1", "cosine"]
M, R, D = 130, 600, 33


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    y = rng.standard_normal((R, D)).astype(np.float32)
    w = np.ones(R, np.float32)
    w[rng.choice(R, 41, replace=False)] = 0.0          # weight-0 slots
    lg = rng.standard_normal(R).astype(np.float32)
    return rng, x, y, w, lg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dnear_kind", ["finite", "inf", "mixed"])
def test_stream_build_plain_matches_jax_kernel(metric, dnear_kind):
    rng, x, y, w, lg = _inputs(11)
    dn = (rng.uniform(0.5, 3.0, R) * np.sqrt(D)).astype(np.float32)
    if dnear_kind == "inf":
        dn[:] = np.inf
    elif dnear_kind == "mixed":
        dn[rng.choice(R, 97, replace=False)] = np.inf
    got = [a.numpy() for a in ops.stream_build_g_stats(
        _t(x), _t(y), _t(dn), _t(w), _t(lg), metric=metric)]
    want = [np.asarray(a) for a in jops.stream_build_g_stats(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(dn), jnp.asarray(w),
        jnp.asarray(lg), metric=metric, interpret=True)]
    dmax = float(ref.pairwise_ref(_t(x), _t(y), metric).abs().max())
    atols = (1e-5 * dmax * R, 1e-5 * dmax ** 2 * R,
             1e-5 * dmax * np.abs(lg).max() * R)
    for g, wv, a in zip(got, want, atols):
        assert g.shape == (M,)
        _close(g, wv, a)
    osum, osq = ref.build_g_ref(_t(x), _t(y), _t(dn), _t(w), metric)
    _close(got[0], osum.numpy(), atols[0])
    _close(got[1], osq.numpy(), atols[1])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 3])
def test_stream_swap_plain_matches_jax_kernel(metric, k):
    rng, x, y, w, lg = _inputs(12 + k)
    d1 = (rng.uniform(0.0, 2.0, R) * 6).astype(np.float32)
    d2 = d1 + (rng.uniform(0.0, 2.0, R) * 6).astype(np.float32)
    if k == 1:
        d2[:] = np.inf                        # no second medoid
    a = rng.integers(0, k, R).astype(np.int32)
    got = [t.numpy() for t in ops.stream_swap_g_stats(
        _t(x), _t(y), _t(d1), _t(d2), _t(a), _t(w), k, _t(lg),
        metric=metric)]
    want = [np.asarray(t) for t in jops.stream_swap_g_stats(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(a), jnp.asarray(w), k, jnp.asarray(lg), metric=metric,
        interpret=True)]
    dmax = max(float(ref.pairwise_ref(_t(x), _t(y), metric).abs().max()),
               float(d1.max()))
    atols = (2e-5 * dmax * R, 4e-5 * dmax ** 2 * R,
             2e-5 * dmax * np.abs(lg).max() * R)
    for g, wv, at in zip(got, want, atols):
        assert g.shape == (k, M)
        _close(g, wv, at)
    osum, osq = ref.swap_g_ref(_t(x), _t(y), _t(d1), _t(d2), _t(a), _t(w),
                               k, metric)
    _close(got[0], osum.numpy(), atols[0])
    _close(got[1], osq.numpy(), atols[1])


def test_stream_defaults_are_unit_weights_and_no_leader():
    rng, x, y, _, _ = _inputs(20)
    dn = np.full(R, np.inf, np.float32)
    s, q, c = ops.stream_build_g_stats(_t(x), _t(y), _t(dn), metric="l2")
    s1, q1, _ = ops.stream_build_g_stats(_t(x), _t(y), _t(dn),
                                         torch.ones(R), torch.zeros(R),
                                         metric="l2")
    assert torch.equal(s, s1) and torch.equal(q, q1)
    assert not c.any()
    d = ref.pairwise_ref(_t(x), _t(y), "l2")
    torch.testing.assert_close(s, d.sum(1), rtol=1e-5, atol=1e-3)


def test_stream_wrappers_validate_inputs():
    _, x, y, w, lg = _inputs(21)
    dn = torch.ones(R)
    with pytest.raises(ValueError, match=r"\[r\]"):
        ops.stream_build_g_stats(_t(x), _t(y), dn[:-1])
    with pytest.raises(ValueError, match="empty"):
        ops.stream_build_g_stats(_t(x), _t(y)[:0], dn[:0])
    with pytest.raises(ValueError, match="int32"):
        ops.stream_swap_g_stats(_t(x), _t(y), dn, dn,
                                torch.zeros(R, dtype=torch.int64), k=2)
    with pytest.raises(ValueError, match="k must be"):
        ops.stream_swap_g_stats(_t(x), _t(y), dn, dn,
                                torch.zeros(R, dtype=torch.int32), k=0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.stream_build_g_stats(_t(x), _t(y), dn, metric="hamming")
