"""The port's SSM blocks (``repro_torch.models.ssm``) held against the
live JAX package (``repro.models.ssm``) on the CPU, on the same numpy
inputs and the JAX ``init_params`` weights of layer 0, at
``get_reduced("falcon_mamba_7b")`` (Mamba-1: d_model 64, d_inner 128,
state 4, dt_rank 8) and ``get_reduced("zamba2_2_7b")`` (Mamba-2: d_inner
128, 8 heads of 16, state 8), B = 2.

Tolerances: the full-sequence outputs, the prefill states and four
decode steps (outputs and states) within rtol 1e-5 and atol
1e-5·max|JAX leaf|: the doubling scan adds in another grouping than
XLA's ``associative_scan`` and the SSD products sum in another order, so
entries near 0 carry the rounding of the largest terms (measured below
1e-6·max); the deterministic init leaves and the scan of a single step
exactly.  The doubling scan against a float64 loop within
1e-5 relative to the largest state.  The float32 matmul precision is
pinned to "highest".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import ssm
from torch_threads import one_intra_op_thread  # noqa: F401

BATCH = 2
DECODE_STEPS = 4


@pytest.fixture(autouse=True)
def _highest_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(old)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1e-30))


ARCHS = {"mamba1": "falcon_mamba_7b", "mamba2": "zamba2_2_7b"}


def _layer(kind, seed=0):
    """Layer 0's SSM weights of the JAX ``init_params`` at the reduced
    config, and the port's block holding them (matrices transposed)."""
    arch = ARCHS[kind]
    cfg = configs.get_reduced(arch)
    params = JM.init_params(jconfigs.get_reduced(arch),
                            jax.random.PRNGKey(seed), dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a[0]), params["groups"][0]["m"])
    block = ssm.Mamba1 if kind == "mamba1" else ssm.Mamba2
    p = block(cfg, device="cpu")
    own = dict(p.named_parameters())
    sd = {}
    for k, v in jp.items():
        if f"{k}.weight" in own:
            sd[f"{k}.weight"] = torch.from_numpy(v.T.copy())
        else:
            sd[k] = torch.from_numpy(v.copy())
    p.load_state_dict(sd)
    return cfg, jax.tree.map(jnp.asarray, jp), p


def _fns(kind):
    if kind == "mamba1":
        return ((jssm.mamba1, jssm.mamba1_prefill, jssm.mamba1_decode),
                (ssm.mamba1, ssm.mamba1_prefill, ssm.mamba1_decode))
    return ((jssm.mamba2, jssm.mamba2_prefill, jssm.mamba2_decode),
            (ssm.mamba2, ssm.mamba2_prefill, ssm.mamba2_decode))


def test_causal_conv_and_gated_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = ssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b))))
    z = rng.standard_normal((BATCH, 11, 6)).astype(np.float32)
    _close(ssm.rms_norm_gated(torch.from_numpy(x), torch.from_numpy(z),
                              torch.from_numpy(b)),
           jssm.rms_norm_gated(jnp.asarray(x), jnp.asarray(z),
                               jnp.asarray(b)))
    s = rng.standard_normal(50).astype(np.float32) * 30
    _close(ssm.softplus(torch.from_numpy(s)), jax.nn.softplus(jnp.asarray(s)))


@pytest.mark.parametrize("l", [1, 2, 3, 5, 8, 13, 32])
def test_linear_scan_matches_a_loop(l):
    """``h_t = a_t·h_{t-1} + b_t`` against a float64 loop, at lengths
    that are and are not powers of two."""
    rng = np.random.default_rng(l)
    a = rng.uniform(0.5, 1.0, (BATCH, l, 3, 2)).astype(np.float32)
    b = rng.standard_normal((BATCH, l, 3, 2)).astype(np.float32)
    got = ssm._linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.zeros_like(b, dtype=np.float64)
    h = np.zeros((BATCH, 3, 2))
    for t in range(l):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got[:, 0], b[:, 0])


@pytest.mark.parametrize("l", [3, 16, 33])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_block_prefill_and_decode_match_jax(kind, l):
    """The full-sequence block, the prefill's output and state, and
    DECODE_STEPS decode steps from it (each from the JAX state in JAX
    and from the port's in the port), the input state left as it was.
    L = 3 is the shortest prompt whose conv tail is the JAX one's (K − 1
    rows); L = 33 is not a multiple of 8 or of a power of two."""
    cfg, jp, p = _layer(kind)
    (jfull, jpre, jdec), (full, pre, dec) = _fns(kind)
    rng = np.random.default_rng(l)
    x = rng.standard_normal((BATCH, l, cfg.d_model)).astype(np.float32)
    _close(full(p, torch.from_numpy(x)), jfull(jp, jnp.asarray(x)))
    y, state = pre(p, torch.from_numpy(x))
    wy, wstate = jpre(jp, jnp.asarray(x))
    _close(y, wy)
    _close(state[0], wstate[0])
    _close(state[1], wstate[1])
    assert state[1].dtype == torch.float32
    for i in range(DECODE_STEPS):
        tok = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        before = [t.clone() for t in state]
        with torch.no_grad():
            y, new = dec(p, torch.from_numpy(tok), state)
        assert all(torch.equal(a, b) for a, b in zip(before, state))
        wy, wstate = jdec(jp, jnp.asarray(tok), wstate)
        _close(y, wy)
        for g, w in zip(new, wstate):
            assert tuple(g.shape) == w.shape
            _close(g, w)
        state = new


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_decode_into_buffers_continues_the_full_sequence(kind):
    """Prefill of L tokens, then a decode step writing its state into
    preallocated tensors, equals the full-sequence block's last output
    over the L + 1 tokens; also from a prompt of 2 < K − 1, whose conv
    tail the port pads with the zeros the convolution saw."""
    cfg, _, p = _layer(kind, seed=1)
    _, (full, pre, dec) = _fns(kind)
    rng = np.random.default_rng(11)
    for l in (2, 12):
        x = torch.from_numpy(rng.standard_normal(
            (BATCH, l + 1, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            want = full(p, x)[:, -1:]
            _, state = pre(p, x[:, :l])
            assert state[0].shape[1] == cfg.ssm_conv - 1
            out = tuple(torch.empty_like(t) for t in state)
            got, new = dec(p, x[:, l:], state, out=out)
        assert all(a is b for a, b in zip(new, out))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_jax(chunk):
    """L = 32: at chunks of 8 and 16 the inter-chunk scan carries the
    state across 4 and 2 chunks; at 32 one chunk holds all."""
    rng = np.random.default_rng(chunk)
    b, l, nh, hd, st = BATCH, 32, 3, 4, 5
    xh = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    bm = rng.standard_normal((b, l, st)).astype(np.float32)
    cm = rng.standard_normal((b, l, st)).astype(np.float32)
    loga = -rng.uniform(0.0, 0.3, (b, l, nh)).astype(np.float32)
    got = ssm._ssd_chunked(*(torch.from_numpy(a) for a in (xh, bm, cm, loga)),
                           chunk)
    want = jssm._ssd_chunked(*(jnp.asarray(a) for a in (xh, bm, cm, loga)),
                             chunk)
    for g, w in zip(got, want):
        _close(g, w)
    # The block at that chunk, against the JAX block at the same chunk.
    cfg, jp, p = _layer("mamba2")
    x = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    _close(ssm.mamba2(p, torch.from_numpy(x), chunk=chunk),
           jssm.mamba2(jp, jnp.asarray(x), chunk=chunk))


def test_ssd_chunk_must_divide_the_sequence():
    cfg, _, p = _layer("mamba2")
    x = torch.zeros((BATCH, 12, cfg.d_model))
    with pytest.raises(ValueError, match="not a multiple"):
        ssm.mamba2(p, x, chunk=8)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_init_leaves_equal_jax(kind):
    """The deterministic leaves (``A_log``, ``D``, ``dt_bias``,
    ``conv_b``, ``norm_w``) equal the JAX init's exactly, dtype included
    under a bfloat16 model; the random ones have the JAX shapes
    (transposed for the projections) and standard deviations within
    10 %."""
    cfg = configs.get_reduced(ARCHS[kind])
    block = ssm.Mamba1 if kind == "mamba1" else ssm.Mamba2
    p = block(cfg, torch.Generator().manual_seed(0), device="cpu",
              dtype=torch.bfloat16)
    init = jssm.init_mamba1 if kind == "mamba1" else jssm.init_mamba2
    want = init(jax.random.PRNGKey(0), jconfigs.get_reduced(ARCHS[kind]),
                jnp.bfloat16)
    own = dict(p.named_parameters())
    assert {k.removesuffix(".weight") for k in own} == set(want)
    for name, leaf in want.items():
        if name in own:
            got = own[name]
            assert str(got.dtype).split(".")[1] == str(leaf.dtype), name
            if name == "conv_w":
                assert tuple(got.shape) == leaf.shape
                assert abs(float(got.detach().float().std()) / 0.2 - 1) < 0.1
            else:
                np.testing.assert_array_equal(
                    got.detach().float().numpy(),
                    np.asarray(leaf.astype(jnp.float32)), err_msg=name)
        else:
            got = own[f"{name}.weight"]
            assert tuple(got.shape) == leaf.shape[::-1], name
            ratio = float(got.detach().float().std()) / float(
                jnp.std(leaf.astype(jnp.float32)))
            assert abs(ratio - 1) < 0.1, (name, ratio)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_prefill_state_owns_its_storage(kind):
    """The prefill's state leaves are tensors of their own size, not
    views of the block's [B, L, ...] buffers, which they would keep
    alive for as long as the state lives (one such buffer a layer)."""
    cfg, _, p = _layer(kind)
    x = torch.randn(BATCH, 16, cfg.d_model)
    with torch.no_grad():
        _, state = (ssm.mamba1_prefill if kind == "mamba1"
                    else ssm.mamba2_prefill)(p, x)
    for leaf in state:
        assert leaf._base is None
        assert leaf.untyped_storage().nbytes() == leaf.numel() * 4
