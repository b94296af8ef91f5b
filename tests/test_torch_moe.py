"""The port's MoE layer (``repro_torch.models.moe``) held against the live
JAX package (``repro.models.moe``) on the CPU, on the same numpy inputs
and the JAX ``init_moe`` weights, at ``get_reduced("arctic_480b")``
(4 experts, top-2) and ``get_reduced("llama4_scout_17b")`` (4 experts,
top-1), d_model 64, B = 2, L = 32.

Tolerances: ``capacity`` and the kept-assignment set exactly (the set of
(token, expert) pairs the dispatch keeps, with drops at capacity factor
0.5 and without them at the configs' 1.25); ``y`` within rtol 1e-5,
atol 1e-6 (float32 products that XLA and PyTorch may round or order
differently in the last bits); the load-balancing loss within rtol 1e-6.
The float32 matmul precision is pinned to "highest".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe
from torch_threads import one_intra_op_thread  # noqa: F401

BATCH, SEQ = 2, 32
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(old)


def _layer(arch, seed=0):
    """Layer 0's MoE weights of the JAX ``init_params`` at ``arch``'s
    reduced config, and the port's MoE module holding them."""
    cfg = configs.get_reduced(arch)
    params = JM.init_params(jconfigs.get_reduced(arch),
                            jax.random.PRNGKey(seed), dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a[0]), params["groups"][0]["moe"])
    p = moe.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, device="cpu")
    p.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in jp.items()})
    return cfg, jp, p


def _jax_kept(jp, x, top_k, cf):
    """The (token, expert) pairs ``repro.models.moe.moe_layer`` keeps at
    one shard: its dispatch lines restated in jnp, since it returns no
    plan (the y comparison below holds the layer itself)."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    t, e = xt.shape[0], jp["router"].shape[1]
    c = jmoe.capacity(t, top_k, e, cf)
    probs = jax.nn.softmax(xt @ jnp.asarray(jp["router"]), axis=-1)
    _, eidx = jax.lax.top_k(probs, top_k)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg = jnp.searchsorted(sorted_e, jnp.arange(e))
    keep = (jnp.arange(t * top_k) - seg[sorted_e]) < c
    return {(int(o) // top_k, int(s)) for o, s, k in
            zip(np.asarray(order), np.asarray(sorted_e), np.asarray(keep))
            if k}, int(np.asarray(eidx).size)


def _port_kept(p, x, top_k, cf):
    r = moe.route(p.router, torch.from_numpy(x.reshape(-1, x.shape[-1])),
                  top_k, cf)
    flat_e = r.eidx.reshape(-1)
    return {(int(o) // top_k, int(flat_e[o])) for o, k in
            zip(r.order, r.keep) if k}


@pytest.mark.parametrize("t", [1, 2, 7, 64, 512, 1000])
def test_capacity_matches_jax(t):
    for k in (1, 2):
        for e in (4, 16, 128):
            for cf in (0.5, 1.0, 1.25, 2.0, 16.0):
                c = moe.capacity(t, k, e, cf)
                assert c == jmoe.capacity(t, k, e, cf), (t, k, e, cf)
                assert c >= 8 and c % 8 == 0


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_scout_17b"])
def test_moe_layer_matches_jax(arch, cf):
    """The kept set exactly, ``y`` and ``aux``; at capacity factor 0.5
    some assignments are dropped (asserted), and for llama4's top-1 the
    JAX layer's zero rows are exactly the port's dropped tokens."""
    cfg, jp, p = _layer(arch)
    cf = cfg.capacity_factor if cf is None else cf
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    want_kept, n_assign = _jax_kept(jp, x, cfg.top_k, cf)
    got_kept = _port_kept(p, x, cfg.top_k, cf)
    assert got_kept == want_kept
    drops = n_assign - len(want_kept)
    assert int(moe.dropped(p, torch.from_numpy(x), top_k=cfg.top_k,
                           capacity_factor=cf)) == drops
    if cf < 1.0:
        assert drops > 0
    wy, waux = jmoe.moe_layer(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              top_k=cfg.top_k, capacity_factor=cf)
    y, aux = moe.moe_layer(p, torch.from_numpy(x), top_k=cfg.top_k,
                           capacity_factor=cf)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(waux), rtol=1e-6)
    if cfg.top_k == 1:
        zero = ~np.asarray(wy).reshape(-1, cfg.d_model).any(-1)
        kept_tokens = {t for t, _ in got_kept}
        assert {int(t) for t in np.flatnonzero(zero)} == (
            set(range(BATCH * SEQ)) - kept_tokens)


@pytest.mark.parametrize("top_k", [1, 2])
def test_ties_take_the_lower_expert(top_k):
    """Equal router probabilities rank the lower expert first, as
    ``jax.lax.top_k`` does: a zero input (every expert tied) and a router
    with two equal columns."""
    d, e = 8, 6
    rng = np.random.default_rng(3)
    router = rng.standard_normal((d, e)).astype(np.float32)
    router[:, 4] = router[:, 1]
    router[:, 5] = router[:, 0]
    x = rng.standard_normal((16, d)).astype(np.float32)
    x[:4] = 0.0
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, want = jax.lax.top_k(probs, top_k)
    r = moe.route(torch.from_numpy(router), torch.from_numpy(x), top_k, 1.25)
    np.testing.assert_array_equal(r.eidx.numpy(), np.asarray(want))
    assert (r.eidx[:4] == torch.arange(top_k)).all()


def test_decode_routing_drops_nothing():
    """A decode step routes B tokens at capacity(B) = 8 slots an expert:
    nothing is dropped, and the layer equals the JAX layer there."""
    cfg, jp, p = _layer("llama4_scout_17b", seed=1)
    x = np.random.default_rng(5).standard_normal(
        (BATCH, 1, cfg.d_model)).astype(np.float32)
    assert moe.capacity(BATCH, cfg.top_k, cfg.n_experts,
                        cfg.capacity_factor) == 8
    assert int(moe.dropped(p, torch.from_numpy(x), top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)) == 0
    wy, waux = jmoe.moe_layer(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor)
    y, aux = moe.moe_layer(p, torch.from_numpy(x), top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(waux), rtol=1e-6)


def test_init_shapes_dtypes_and_scales():
    """The JAX ``init_moe`` shapes; the router float32 under a bfloat16
    model; standard deviations d**-0.5 and ff**-0.5 within 5 %."""
    d, ff, e = 64, 256, 8
    p = moe.MoE(d, ff, e, torch.Generator().manual_seed(0), device="cpu",
                dtype=torch.bfloat16)
    want = jmoe.init_moe(jax.random.PRNGKey(0), d, ff, e, jnp.bfloat16)
    for name, leaf in want.items():
        got = getattr(p, name)
        assert tuple(got.shape) == leaf.shape, name
        assert str(got.dtype).split(".")[1] == str(leaf.dtype), name
    for name, std in (("router", d ** -0.5), ("wi", d ** -0.5),
                      ("wg", d ** -0.5), ("wo", ff ** -0.5)):
        assert abs(float(getattr(p, name).detach().float().std()) / std
                   - 1) < 0.05
