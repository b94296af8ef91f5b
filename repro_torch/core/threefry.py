"""The JAX package's random draws in PyTorch: threefry2x32 and the
``jax.random`` functions the package calls, bit for bit.

This is jax's partitionable threefry path (``jax_threefry_partitionable``
on, jax's default since 0.5), with 64-bit types off (jax's default):

* :func:`PRNGKey` — ``jax.random.PRNGKey(seed)``.  jax narrows a Python
  int to int32 before ``threefry_seed`` splits it into its high and low
  words, so the key is ``(0, seed mod 2**32)`` for any seed in
  ``[-2**63, 2**63)``, negative seeds and seeds ≥ 2**32 included;
* :func:`split`, :func:`fold_in` — the key derivations (``fold_in``
  also over a tensor of data words, one key per word);
* :func:`random_bits` — 32-bit words: threefry of the key over the
  64-bit iota of the shape (high and low words), the two outputs xored;
* :func:`randint` — ``_randint``: two split keys give high and low
  words, reduced modulo the span through the ``2**32 mod span``
  multiplier;
* :func:`permutation` — ``_shuffle``: ``ceil(3·ln n / ln(2**32 − 1))``
  rounds, each a fresh split and a STABLE sort by 32-bit keys
  (``lax.sort_key_val`` is stable, and at n = 60,000 keys collide);
* :func:`choice` — without replacement ``permutation(key, n)[:size]``,
  with replacement ``randint(key, shape, 0, n)``;
* :func:`uniform` — float32 in ``[minval, maxval)`` from the top 23 bits,
  scaled by XLA's fused multiply-add; for one key or a batch of keys;
* :func:`normal` — ``_normal_real``: ``sqrt(2)·erf_inv(u)``, ``u``
  uniform on ``(nextafter(-1, 0), 1)``, with :func:`erf_inv` the float32
  ``erf_inv`` that XLA's CPU backend compiles (Giles' polynomial over its
  own ``log1p`` and ``log``, every multiply-add fused, as it emits them
  on an x86-64 CPU with FMA3).

A key is a pair of host ints, so deriving one never touches a device.
Bits are computed on the given device, in int64 tensors that hold
uint32 values (every sum and product is masked with ``& 0xFFFFFFFF``,
since torch's uint32 coverage is thin): the same key gives the same bits
on the CPU and on the card.  :func:`threefry2x32` takes ints or tensors
alike, so a batch of keys (one per row) runs as one tensor computation
(:func:`randint_rows`).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word
                 ) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under key (k1, k2); ints or int64 tensors of uint32 values, which
    broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return (0, seed & MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: key i is threefry over the count
    pair (i >> 32, i mod 2**32)."""
    k1, k2 = key
    return [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(int(num))]


def fold_in(key: Key, data: Word) -> Tuple[Word, Word]:
    """``jax.random.fold_in(key, data)``, ``data`` taken as uint32.  For
    an int64 tensor of data words the result is one key per element: a
    pair of tensors of its shape (``uniform`` takes such a pair)."""
    if not isinstance(data, torch.Tensor):
        data = int(data)
    return threefry2x32(key[0], key[1], 0, data & MASK)


def _bits(k1: Word, k2: Word, size: int, device) -> torch.Tensor:
    """32-bit words for flat positions ``[0, size)``; key words that are
    tensors of shape [R, 1] give one row per key, [R, size]."""
    idx = torch.arange(size, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def random_bits(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    shape = _shape(shape)
    return _bits(key[0], key[1], math.prod(shape), device).reshape(shape)


def _span(minval: int, maxval: int) -> int:
    for v in (minval, maxval):
        if not _INT32_MIN <= v <= _INT32_MAX:
            raise ValueError(f"randint bounds must fit in int32, got {v}")
    return 1 if maxval <= minval else maxval - minval


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a·b mod 2**32`` for uint32 values, without leaving int64."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & MASK


def _reduce(hi: torch.Tensor, lo: torch.Tensor, minval: int,
            span: int) -> torch.Tensor:
    """``_randint``'s reduction of the high and low words into
    ``[minval, minval + span)``, in uint32 arithmetic."""
    # jax squares 2**16 mod span in uint32, which wraps past span 2**16.
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    return minval + ((_mul32(hi % span, mult) + lo % span) & MASK) % span


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host key words on ``device``: on a card through pinned memory and
    an asynchronous copy (a copy from pageable memory would wait for the
    device)."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def randint_rows(keys: Sequence[Key], size: int, minval: int, maxval: int,
                 device="cpu") -> torch.Tensor:
    """``randint(key, (size,), minval, maxval)`` for each key, one row
    each: ``[len(keys), size]`` int64, computed as one tensor pass."""
    minval, maxval = int(minval), int(maxval)
    span = _span(minval, maxval)
    words = [w for key in keys for sub in split(key) for w in sub]
    kt = _upload(torch.tensor(words, dtype=torch.int64).view(len(keys), 4),
                 device)
    return _reduce(_bits(kt[:, 0:1], kt[:, 1:2], size, device),
                   _bits(kt[:, 2:3], kt[:, 3:4], size, device), minval, span)


def randint(key: Key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 bounds)
    as an int64 tensor."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    span = _span(minval, maxval)
    k_hi, k_lo = split(key)
    size = math.prod(shape)
    return _reduce(_bits(k_hi[0], k_hi[1], size, device),
                   _bits(k_lo[0], k_lo[1], size, device), minval,
                   span).reshape(shape)


def shuffle_rounds(n: int) -> int:
    """The sort rounds of ``_shuffle`` for n elements (float64, as jax
    computes it)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 tensor."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(_bits(sub[0], sub[1], n, device),
                           stable=True).indices
        x = x.index_select(0, order)
    return x


def permutations(keys: Sequence[Key], n: int,
                 device="cpu") -> torch.Tensor:
    """``[permutation(key, n) for key in keys]`` as one ``[len(keys), n]``
    int64 tensor, each round's bits and stable sort computed for every
    key at once (the JAX package's vmapped ``_batch_perms``).  A stable
    sort's order is a function of its keys alone, so each row is
    :func:`permutation`'s bit for bit."""
    n = int(n)
    keys = list(keys)
    x = torch.arange(n, dtype=torch.int64, device=device).expand(
        len(keys), n)
    for _ in range(shuffle_rounds(n)):
        subs = []
        for i, key in enumerate(keys):
            keys[i], sub = split(key)
            subs.append(sub)
        k1, k2 = (_upload(torch.tensor([sub[j] for sub in subs],
                                       dtype=torch.int64), device)[:, None]
                  for j in (0, 1))
        order = torch.sort(_bits(k1, k2, n, device), dim=1,
                           stable=True).indices
        x = torch.gather(x, 1, order)
    return x


def choice(key: Key, n: int, shape, replace: bool = True,
           device="cpu") -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` (uniform weights)."""
    shape = _shape(shape)
    size = math.prod(shape)
    if size == 0:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if replace:
        return randint(key, shape, 0, n, device)
    if size > n:
        raise ValueError(f"Cannot take a larger sample (size {size}) than "
                         f"population (size {n}) when 'replace=False'")
    return permutation(key, n, device)[:size].reshape(shape)


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  A key
    whose words are tensors of one shape S (``fold_in`` over a tensor of
    data words) is a batch of keys: the result is S + shape, on their
    device, each key's draw as jax's ``vmap`` of ``uniform`` gives it."""
    shape = _shape(shape)
    k1, k2 = key
    batch = ()
    if isinstance(k1, torch.Tensor):
        batch, device = tuple(k1.shape), k1.device
        k1, k2 = k1.reshape(-1, 1), k2.reshape(-1, 1)
    bits = _bits(k1, k2, math.prod(shape), device)
    one = (bits >> 9) | 0x3F800000                  # [1, 2) in float32
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # XLA contracts ``floats·(hi − lo) + lo`` into one fused multiply-add:
    # the float32 product is exact in float64, so the add is rounded
    # there and then to float32.  The bounds are host scalars (a tensor
    # made from them would be a copy to the device).
    lo, hi = np.float32(minval), np.float32(maxval)
    out = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(out, float(lo)).reshape(batch + shape)


# XLA's float32 ``ErfInv`` (Giles, "Approximating the erfinv function"):
# the coefficients of its ``w < 5`` and ``sqrt(w) - 3`` branches, highest
# degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA:CPU's ``log1p``: a Cephes rational for |x| < sqrt(2) - 1 ...
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# ... and its float32 ``log`` elsewhere (Cephes' ``logf``): the mantissa
# in [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial in three chains.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _f32(c: float) -> float:
    return float(np.float32(c))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as an FMA instruction gives it.
    The product is exact in float64; the sum is rounded to odd there
    (TwoSum's error moves an even result one ulp towards it), and a
    value rounded to odd with 29 spare bits rounds to float32 as the
    exact sum would.  Every step is an IEEE float64 operation, so the
    CPU and the card give the same bits."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c = c.double() if isinstance(c, torch.Tensor) else c
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``fma(... fma(x, c0, c1) ..., x, cn)``, each ``c`` a float32
    value or a tensor of them shaped as ``x``."""
    acc = _fma(x, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        acc = _fma(acc, x, c)
    return acc


def _log_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log`` of ``x`` (its instruction order)."""
    xc = torch.clamp_min(x, _f32(1.1754943508222875e-38))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _f32(0.7071067690849304)
    r = (m - 1.0) + torch.where(small, m, 0.0)
    e = torch.where(small, e - 1.0, e)
    r2 = r * r
    r3 = r2 * r
    p = _LOG_P
    a = _fma(_fma(r, _f32(p[0]), _f32(p[1])), r, _f32(p[2]))
    b = _fma(_fma(r, _f32(p[3]), _f32(p[4])), r, _f32(p[5]))
    c = _fma(_fma(r, _f32(p[6]), _f32(p[7])), r, _f32(p[8]))
    y = _fma(_fma(_fma(a, r3, b), r3, c), r3, e * _f32(_LOG_Q1))
    y = _fma(e, _f32(_LOG_Q2), _fma(-r2, 0.5, r) + y)
    y = torch.where(x <= 0, math.nan, y)                  # x < 0 or NaN
    y = torch.where(x == 0, -math.inf, y)
    return torch.where(x == math.inf, math.inf, y)


def _log1p_xla(t: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p``."""
    t2 = t * t
    # float64 then float32: the float32 quotient, correctly rounded.
    q = (_horner(t, [_f32(c) for c in _LOG1P_NUM]).double()
         / _horner(t, [_f32(c) for c in _LOG1P_DEN]).double()).float()
    small = _fma(t2, -0.5, (t * t2) * q)
    return torch.where(t.abs() < _f32(0.4142135679721832), t + small,
                       _log_xla(t + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of a float32 tensor as jax computes it on an
    x86-64 CPU, bit for bit (module docstring): ``w = -log1p(-x²)``,
    Giles' polynomial in ``w - 2.5`` below 5 and in ``sqrt(w) - 3``
    above, times ``x``; ±inf at ±1.  The quotient and the square root
    are correctly rounded in float32 on either device.  XLA:CPU flushes
    subnormals to zero, so a subnormal input or result is a signed 0
    here too."""
    x = _flush(x.float())
    lg = _log1p_xla(-x * x)
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg,
                    torch.sqrt(-lg.double()).float() - 3.0)
    coef = [torch.where(lt, _f32(a), _f32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = _horner(w, coef)
    return _flush(x * torch.where(x.abs() == 1.0, math.inf, p))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0.0, x)


def normal(key, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``_normal_real``'s
    ``sqrt(2)·erf_inv(u)`` with ``u`` uniform on ``(nextafter(-1, 0),
    1)``, bit for bit with jax on an x86-64 CPU (:func:`erf_inv`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _f32(math.sqrt(2.0)) * erf_inv(u)
