"""The port's threefry (``repro_torch.core.threefry``) against
``jax.random`` on the CPU, bit for bit: keys from seeds (negative, 0,
past 2**32), ``split``, ``fold_in``, ``random_bits``, ``randint``,
``permutation``, ``choice``, ``uniform`` and ``normal`` (with
``erf_inv``), over sizes n = 1, 2, 100,
4,097 and 60,000 and several shapes; ``fold_in`` and ``uniform`` also
over tensors of data words (the serving reservoir's draws).

The port replays jax's partitionable threefry path with 64-bit types
off; the first test fails loudly if this jax draws otherwise.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import rng, threefry
from torch_threads import one_intra_op_thread  # noqa: F401

SEEDS = st.one_of(st.integers(-2 ** 63, 2 ** 63 - 1),
                  st.sampled_from([0, 1, -1, 2 ** 32, 2 ** 32 + 5,
                                   -2 ** 31 - 1, 2 ** 63 - 1]))
SIZES = st.sampled_from([1, 2, 100, 4097, 60000])
CASES = settings(max_examples=12, deadline=None)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(t):
    return t.numpy()


def test_jax_draws_the_partitionable_path():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@CASES
@given(seed=SEEDS, num=st.integers(1, 7), data=st.integers(0, 2 ** 32 - 1))
def test_key_split_and_fold_in(seed, num, data):
    key = threefry.PRNGKey(seed)
    assert list(key) == np.asarray(_jkey(seed)).tolist()
    assert [list(k) for k in threefry.split(key, num)] == np.asarray(
        jax.random.split(_jkey(seed), num)).tolist()
    assert list(threefry.fold_in(key, data)) == np.asarray(
        jax.random.fold_in(_jkey(seed), data)).tolist()


def test_seeds_past_int64_raise_as_in_jax():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2 ** 64)
    with pytest.raises(OverflowError):
        threefry.PRNGKey(2 ** 64)


@CASES
@given(seed=SEEDS, data=st.lists(st.integers(-2 ** 63, 2 ** 63 - 1),
                                 min_size=1, max_size=40))
def test_fold_in_over_a_tensor_of_data_words(seed, data):
    """One key per data word, each ``jax.random.fold_in`` of the word as
    uint32 (jax takes an int64 index as int32 with 64-bit types off, so
    the word is the index mod 2**32)."""
    words = np.asarray(data, np.int64)
    k1, k2 = threefry.fold_in(threefry.PRNGKey(seed), torch.from_numpy(words))
    got = np.stack([_np(k1), _np(k2)], axis=1)
    want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(_jkey(seed), i))(
        jax.numpy.asarray(words.astype(np.uint32))))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@CASES
@given(seed=SEEDS, words=st.lists(st.integers(0, 2 ** 32 - 1), min_size=1,
                                  max_size=40),
       shape=st.sampled_from([(), (3,), (2, 4)]),
       bounds=st.sampled_from([(0.0, 1.0), (-2.5, 7.3)]))
def test_uniform_over_a_batch_of_keys(seed, words, shape, bounds):
    """``uniform`` of ``fold_in`` over a tensor of words equals jax's
    ``vmap`` of ``uniform(fold_in(key, i), shape)``, bit for bit."""
    lo, hi = bounds
    w = np.asarray(words, np.uint32)
    want = np.asarray(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(_jkey(seed), i), shape, minval=lo,
        maxval=hi))(jax.numpy.asarray(w)))
    keys = threefry.fold_in(threefry.PRNGKey(seed),
                            torch.from_numpy(w.astype(np.int64)))
    got = _np(threefry.uniform(keys, shape, lo, hi))
    assert got.shape == (len(words),) + shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@CASES
@given(seed=SEEDS, shape=st.sampled_from([(1,), (7,), (3, 5), (2, 3, 4),
                                          (4097,)]))
def test_random_bits(seed, shape):
    want = np.asarray(jax.random.bits(_jkey(seed), shape)).astype(np.int64)
    np.testing.assert_array_equal(
        _np(threefry.random_bits(threefry.PRNGKey(seed), shape)), want)


@CASES
@given(seed=SEEDS, shape=st.sampled_from([(100,), (3, 4), (1,)]),
       bounds=st.sampled_from([(0, 60000), (0, 1), (5, 5), (9, 3),
                               (-100, 100), (0, 2 ** 16), (0, 2 ** 16 + 1),
                               (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)]))
def test_randint(seed, shape, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.randint(_jkey(seed), shape, lo, hi))
    np.testing.assert_array_equal(
        _np(threefry.randint(threefry.PRNGKey(seed), shape, lo, hi)), want)


@CASES
@given(seed=SEEDS, n=SIZES)
def test_permutation(seed, n):
    want = np.asarray(jax.random.permutation(_jkey(seed), n))
    np.testing.assert_array_equal(
        _np(threefry.permutation(threefry.PRNGKey(seed), n)), want)


@CASES
@given(seed=SEEDS, n=SIZES, frac=st.floats(0.0, 1.0))
def test_choice_without_replacement(seed, n, frac):
    b = max(1, int(frac * n))
    want = np.asarray(jax.random.choice(_jkey(seed), n, (b,),
                                        replace=False))
    np.testing.assert_array_equal(
        _np(threefry.choice(threefry.PRNGKey(seed), n, (b,),
                            replace=False)), want)


@CASES
@given(seed=SEEDS, n=SIZES, shape=st.sampled_from([(5,), (3, 4)]))
def test_choice_with_replacement(seed, n, shape):
    want = np.asarray(jax.random.choice(_jkey(seed), n, shape))
    np.testing.assert_array_equal(
        _np(threefry.choice(threefry.PRNGKey(seed), n, shape)), want)


@CASES
@given(seed=SEEDS, shape=st.sampled_from([(8,), (3, 5), (1000,)]),
       bounds=st.sampled_from([(0.0, 1.0), (-2.5, 7.3), (0.1, 0.7),
                               (3.0, 1e6)]))
def test_uniform(seed, shape, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(_jkey(seed), shape, minval=lo,
                                         maxval=hi))
    got = _np(threefry.uniform(threefry.PRNGKey(seed), shape, lo, hi))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@CASES
@given(seed=SEEDS, shape=st.sampled_from([(1,), (8,), (3, 5), (2, 8, 64),
                                          (4097,)]))
def test_normal(seed, shape):
    """``jax.random.normal`` bit for bit: the uniform on (nextafter(-1,
    0), 1) and XLA's float32 ``erf_inv`` (its ``log1p`` and ``log``
    polynomials with every multiply-add fused), times sqrt(2)."""
    want = np.asarray(jax.random.normal(_jkey(seed), shape))
    got = _np(threefry.normal(threefry.PRNGKey(seed), shape))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_at_two_million_draws():
    """2,000,000 draws, all bits equal; ``torch.erfinv`` of the same
    uniforms differs from ``lax.erf_inv`` in most of them (why the port
    carries XLA's polynomial)."""
    key = threefry.PRNGKey(3)
    want = np.asarray(jax.random.normal(_jkey(3), (2_000_000,)))
    got = _np(threefry.normal(key, (2_000_000,)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = threefry.uniform(key, (2_000_000,), lo, 1.0)
    plain = _np(np.float32(np.sqrt(2.0)) * torch.erfinv(u))
    assert (plain.view(np.int32) != want.view(np.int32)).mean() > 0.5


def test_erf_inv_over_its_domain():
    """Both branches (w < 5 and the tail), both ``log1p`` routes
    (|x²| below and above sqrt(2) − 1), ±0, the uniform's extremes, the
    last floats below 1 and ±1 (±inf), bit for bit."""
    edge = np.float32([0.0, -0.0, 1.0, -1.0, 1e-30, -1e-38, 0.5, 0.99,
                       np.nextafter(np.float32(1), np.float32(0)),
                       np.nextafter(np.float32(-1), np.float32(0)),
                       0.6435942529055827, 0.9966158])
    x = np.concatenate([np.linspace(-1, 1, 400_001, dtype=np.float32), edge,
                        1 - np.float32(2.0) ** -np.arange(1, 24,
                                                        dtype=np.float32)])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = _np(threefry.erf_inv(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@CASES
@given(seed=SEEDS, rows=st.integers(1, 6), n=st.sampled_from([7, 650]))
def test_randint_rows_is_randint_per_key(seed, rows, n):
    keys = threefry.split(threefry.PRNGKey(seed), rows)
    got = _np(threefry.randint_rows(keys, 100, 0, n))
    for key, row in zip(jax.random.split(_jkey(seed), rows), got):
        np.testing.assert_array_equal(
            row, np.asarray(jax.random.randint(key, (100,), 0, n)))


def test_seed_layouts_replay_the_fit_chain():
    """``rng.from_seed`` gives the JAX fit's fixed permutation, per-search
    permutations and replacement draws (``_batch_rng_chains``), whatever
    order the searches ask in."""
    from repro.core.banditpam import _batch_perms, _batch_rng_chains
    from test_torch_banditpam import jax_draws
    seed, n, k, T = 11, 650, 4, 26
    ckey, _, _, bpk, spk = _batch_rng_chains(jax.numpy.asarray([seed]), k=k,
                                             T=T)
    src = rng.from_seed(seed, "cpu", k)
    want_swap = np.asarray(_batch_perms(spk[0], n=n))
    for t in (5, 0, T - 1):                       # any order
        np.testing.assert_array_equal(_np(src.swap_perm(t, n)), want_swap[t])
    want_build = np.asarray(_batch_perms(bpk[0], n=n))
    for i in range(k):
        np.testing.assert_array_equal(_np(src.build_perm(i, n)),
                                      want_build[i])
    np.testing.assert_array_equal(
        _np(src.fixed_perm(n)),
        np.asarray(jax.random.permutation(ckey[0], n)))
    bd, sd = jax_draws(seed, n, k)
    for t, rnd in ((3, 6), (0, 0), (3, 0)):
        np.testing.assert_array_equal(_np(src.swap_draw(t, rnd, n, 100)),
                                      sd[t, rnd])
    for i in range(k):
        for rnd in range(bd.shape[1]):
            np.testing.assert_array_equal(
                _np(src.build_draw(i, rnd, n, 100)), bd[i, rnd])
    with pytest.raises(ValueError, match="at most 7"):
        src.build_draw(0, 7, n, 100)
