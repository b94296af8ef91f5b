"""The port's LM substrate (``repro_torch.configs``, ``models``,
``train.data``, ``train.curated``, the LM half of ``convert``) held
against the live JAX package on the CPU, on the same numpy inputs, at
``get_reduced("qwen3_1_7b")`` (2 layers, d_model 64, 4 heads over 2 kv
heads, vocab 256), B = 2, L = 32; the forward, the parameter names and
the decay rule also at the reduced MoE (arctic, llama4), Mamba-1
(falcon-mamba) and hybrid (zamba2) configs, whose blocks
``tests/test_torch_moe.py`` and ``tests/test_torch_ssm.py`` hold, and at
the two frontends' (phi-3-vision: 8 projected patch embeddings before 24
text tokens; musicgen: 2 codebooks summed in, one head each), whose
batches, ``patch_emb`` included, equal the JAX batches bit for bit.

Tolerances: the building blocks within rtol 1e-5, atol 1e-6 (float32
ops that XLA and PyTorch may round or order differently in the last
bits); the logits within 1e-5·max|logits|; the synthetic batches, the
configs and the clustering of equal embeddings exactly.  The float32
matmul precision is pinned to "highest" (ROADMAP C3: a process-wide
lower precision reaches oneDNN's bf16 path).
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import BanditPAM as JBanditPAM
from repro.core import medoid_cache as jmedoid_cache
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import data as jdata
from repro_torch import configs, convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import curated
from repro_torch.train import data
from repro_torch.train import optimizer
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen3_1_7b"
FAMILIES = ("arctic_480b", "llama4_scout_17b", "falcon_mamba_7b",
            "zamba2_2_7b", "phi3_vision_4_2b", "musicgen_large")
BATCH, SEQ = 2, 32
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(old)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def configs_j():
    return jconfigs.get_reduced(ARCH)


def _jax_params(cfg, seed=0):
    return JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)


def _port_model(params, cfg):
    model = M.init_params(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu"))
    return model


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_the_jax_config(arch):
    for get in ("get_config", "get_reduced"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        assert got.param_count() == want.param_count(), get
        assert got.pattern_for_all_layers() == want.pattern_for_all_layers()
        assert (configs.supports_long_context(got)
                == jconfigs.supports_long_context(want))
    assert configs.cells(arch) == jconfigs.cells(arch)


def test_arch_ids_and_shapes_equal():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    full = configs.get_config(ARCH)
    assert full.param_count()["total"] == 2_031_616_000


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x, w = _randn(rng, BATCH, SEQ, 4, 16), _randn(rng, 16)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.arange(SEQ)
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_attn_qkv_with_qk_norm_and_mlp():
    cfg = configs.get_reduced(ARCH)
    assert cfg.qk_norm and cfg.n_kv_heads < cfg.n_heads
    params = _jax_params(configs.get_reduced(ARCH))
    model = _port_model(params, cfg)
    lp = jax.tree.map(lambda a: a[0], params["groups"][0])
    rng = np.random.default_rng(1)
    x = _randn(rng, BATCH, SEQ, cfg.d_model)
    pos = np.arange(SEQ)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
              theta=cfg.rope_theta, qk_norm=True)
    got = L.attn_qkv(model.layers[0].attn, torch.from_numpy(x),
                     torch.from_numpy(pos), **kw)
    want = JL.attn_qkv(lp["attn"], jnp.asarray(x), jnp.asarray(pos), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    _close(L.mlp(model.layers[0].mlp, torch.from_numpy(x)),
           JL.mlp(lp["mlp"], jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_attention_matches_by_kind(kind):
    """Window 8 and 8-row chunks over L = 32: each query chunk walks
    several kv chunks, and GQA (4 heads over 2) tells ``repeat_interleave``
    from ``repeat``."""
    rng = np.random.default_rng(2)
    q = _randn(rng, BATCH, SEQ, 4, 16)
    k, v = _randn(rng, BATCH, SEQ, 2, 16), _randn(rng, BATCH, SEQ, 2, 16)
    kw = dict(kind=kind, window=8, q_chunk=8, kv_chunk=8)
    got = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), **kw)
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(got, want)
    # One chunk for the whole sequence: the same answer.
    one = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), kind=kind, window=8)
    _close(one, want)


@pytest.mark.parametrize("arch", [ARCH, "gemma3_12b", *FAMILIES])
def test_forward_logits_match(arch):
    """qwen3's global layers; gemma3's five local layers (window 16 < L)
    and one global; arctic's MoE top-2 with the dense residual (B·L = 64
    tokens at 48 slots an expert), llama4's top-1 with the shared expert
    over chunked and global layers (window 32); falcon-mamba's Mamba-1
    layers and tied embeddings; zamba2's Mamba-2 layers and the shared
    block; phi-3-vision's patch prefix; musicgen's codebooks."""
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    params = _jax_params(jcfg)
    model = _port_model(params, cfg)
    full = data.synthetic_batch(cfg, BATCH, SEQ, 0, device="cpu")
    inp = {k: v for k, v in full.items() if k in ("tokens", "patch_emb")}
    want, jaux = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(
        params, {k: jnp.asarray(v.numpy()) for k, v in inp.items()})
    got, aux = model(inp)
    want = np.asarray(want)
    shape = (BATCH, SEQ) + ((cfg.n_codebooks,) if cfg.frontend ==
                            "audio_stub" else ()) + (cfg.vocab,)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert (float(aux.detach()) == 0.0) == (cfg.n_experts == 0)
    # The checkpointed groups (autograd on) and the plain path (off) give
    # the same bits.
    with torch.no_grad():
        assert torch.equal(model(inp)[0], got)


def test_lm_params_cover_the_model():
    cfg = configs.get_reduced("gemma3_12b")       # 6 layers, pattern of 6
    params = _jax_params(jconfigs.get_reduced("gemma3_12b"))
    conv = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                            device="cpu")
    own = M.params_of(M.init_params(cfg, device="cpu"))
    assert {n: tuple(p.shape) for n, p in conv.items()} == {
        n: tuple(p.shape) for n, p in own.items()}
    # Layer i of a pattern of length P is groups[i % P][leaf][i // P].
    per = len(cfg.layer_pattern)
    np.testing.assert_array_equal(
        conv["layers.5.attn.wq.weight"].numpy(),
        np.asarray(params["groups"][5 % per]["attn"]["wq"][5 // per]).T)
    assert sum(p.numel() for p in own.values()) == (
        cfg.param_count()["total"] + cfg.d_model * (2 * cfg.n_layers + 1)
        + 2 * cfg.hd * cfg.n_layers)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_params_cover_each_family(arch):
    """The JAX tree crosses to the port's own parameter names and shapes,
    every leaf of it (the element counts equal); for the attention
    families also against ``param_count`` plus the norms it leaves out
    (its Mamba formula is approximate, ``configs/base.py``)."""
    cfg = configs.get_reduced(arch)
    params = _jax_params(jconfigs.get_reduced(arch))
    conv = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                            device="cpu")
    own = M.params_of(M.init_params(cfg, device="cpu"))
    assert {n: tuple(p.shape) for n, p in conv.items()} == {
        n: tuple(p.shape) for n, p in own.items()}
    n_jax = sum(int(np.asarray(a).size) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in own.values()) == n_jax
    if cfg.n_experts:
        assert sum(p.numel() for p in own.values()) == (
            cfg.param_count()["total"] + cfg.d_model * (2 * cfg.n_layers + 1))
        # The MoE leaves cross untransposed: [E, d, ff] in both.
        np.testing.assert_array_equal(
            conv["layers.1.moe.wi"].numpy(),
            np.asarray(params["groups"][1 % len(cfg.layer_pattern)]["moe"][
                "wi"][1 // len(cfg.layer_pattern)]))
    if cfg.ssm_state:
        np.testing.assert_array_equal(
            conv["layers.1.m.out_proj.weight"].numpy(),
            np.asarray(params["groups"][1 % len(cfg.layer_pattern)]["m"][
                "out_proj"][1 // len(cfg.layer_pattern)]).T)
    if cfg.frontend == "vision_stub":
        np.testing.assert_array_equal(conv["vision_proj.weight"].numpy(),
                                      np.asarray(params["vision_proj"]).T)
    if cfg.frontend == "audio_stub":
        # [nc, V, d] and [nc, d, V]: the einsum's operands, untransposed.
        for leaf in ("embed", "lm_head"):
            np.testing.assert_array_equal(conv[f"{leaf}.weight"].numpy(),
                                          np.asarray(params[leaf]))


@pytest.mark.parametrize("arch", [ARCH, *FAMILIES])
def test_decay_rule_equals_jax_ndim(arch):
    """``optimizer.decays`` is the JAX ``ndim >= 2`` leaf for leaf: a
    tree whose every leaf is filled with its own rule crosses through
    ``convert`` onto the port's names.  Every stacked layer leaf decays
    (``A_log``, ``D``, ``dt_bias`` and the norms too); the shared block's
    norms and the final norm do not."""
    cfg = configs.get_reduced(arch)
    params = _jax_params(jconfigs.get_reduced(arch))
    marks = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2),
                                           np.float32), params)
    conv = convert.lm_params_from_reference(marks, device="cpu")
    own = M.params_of(M.init_params(cfg, device="cpu"))
    assert conv.keys() == own.keys()
    for name, p in own.items():
        want = bool(conv[name].flatten()[0])
        assert bool((conv[name] == float(want)).all()), name
        assert optimizer.decays(name, p) == want, name
    if "shared_attn.ln1.weight" in own:
        assert not optimizer.decays("shared_attn.ln1.weight",
                                    own["shared_attn.ln1.weight"])
        assert optimizer.decays("layers.0.m.A_log", own["layers.0.m.A_log"])


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    for build in (lambda: M.Decoder(cfg),
                  lambda: L.RMSNorm(cfg.d_model),
                  lambda: L.MLP(cfg.d_model, cfg.d_ff),
                  lambda: L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, cfg.d_model, cfg.qk_norm)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="CUDA"):
        data.synthetic_batch(cfg, BATCH, SEQ, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        curated.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("step", [0, 1, 10_000])
def test_synthetic_batch_equals_jax(seed, step):
    want = jdata.synthetic_batch(configs_j(), BATCH, SEQ, step,
                                 jdata.DataConfig(seed=seed))
    got = data.synthetic_batch(configs.get_reduced(ARCH), BATCH, SEQ, step,
                               data.DataConfig(seed=seed), device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_audio_batch_equals_jax():
    """[B, L, codebooks] tokens and labels."""
    want = jdata.synthetic_batch(jconfigs.get_reduced("musicgen_large"),
                                 BATCH, SEQ, 3)
    got = data.synthetic_batch(configs.get_reduced("musicgen_large"), BATCH,
                               SEQ, 3, device="cpu")
    assert got.keys() == want.keys()
    assert got["tokens"].shape == (BATCH, SEQ, 2)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("step", [0, 3, 10_000])
def test_vision_batch_equals_jax(step):
    """``seq − P`` text tokens, ``patch_emb`` [B, P, d] (threefry's
    normal draws, bit for bit), labels and loss mask zero over the P
    patches."""
    jcfg = jconfigs.get_reduced("phi3_vision_4_2b")
    cfg = configs.get_reduced("phi3_vision_4_2b")
    want = jdata.synthetic_batch(jcfg, BATCH, SEQ, step)
    got = data.synthetic_batch(cfg, BATCH, SEQ, step, device="cpu")
    assert got.keys() == want.keys()
    p = cfg.n_patches
    assert got["tokens"].shape == (BATCH, SEQ - p)
    assert got["patch_emb"].shape == (BATCH, p, cfg.d_model)
    assert got["patch_emb"].dtype == torch.float32
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype ==
                                      np.float32 else g,
                                      w.view(np.int32) if w.dtype ==
                                      np.float32 else w)
    assert not got["loss_mask"][:, :p].any() and not got["labels"][:, :p].any()


def test_data_pipeline_state_and_resume():
    cfg, jcfg = configs.get_reduced(ARCH), configs_j()
    pipe = data.DataPipeline(cfg, BATCH, SEQ, data.DataConfig(seed=1),
                             device="cpu")
    jpipe = jdata.DataPipeline(jcfg, BATCH, SEQ, jdata.DataConfig(seed=1))
    for _ in range(2):
        b, jb = next(pipe), next(jpipe)
    np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
    assert pipe.state() == jpipe.state() == {"step": 2, "seed": 1}
    resumed = data.DataPipeline.from_state(cfg, BATCH, SEQ, pipe.state(),
                                           device="cpu")
    a, c = next(pipe), next(resumed)
    assert all(torch.equal(a[k], c[k]) for k in a)
    np.testing.assert_array_equal(c["labels"].numpy(),
                                  np.asarray(next(jpipe)["labels"]))


@pytest.mark.parametrize("arch", ["phi3_vision_4_2b", "musicgen_large"])
def test_frontend_pipelines_resume(arch):
    """A frontend's pipeline resumed from its state gives the next
    batches, the JAX pipeline's bits (``patch_emb`` included)."""
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    pipe = data.DataPipeline(cfg, BATCH, SEQ, data.DataConfig(seed=2),
                             device="cpu")
    jpipe = jdata.DataPipeline(jcfg, BATCH, SEQ, jdata.DataConfig(seed=2))
    next(pipe), next(jpipe)
    resumed = data.DataPipeline.from_state(cfg, BATCH, SEQ, pipe.state(),
                                           device="cpu")
    a, c, jb = next(pipe), next(resumed), next(jpipe)
    assert a.keys() == c.keys() == jb.keys()
    for k in a:
        assert torch.equal(a[k], c[k])
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# curation
# ---------------------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_curated", ROOT / "examples" / "train_lm_curated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_curation_matches_the_jax_example():
    """The pool's embeddings within the logits' tolerance; on the SAME
    numpy embeddings the port's medoids, assignment and weights equal
    those of the JAX example's ``curate_weights`` (its fit, top-2 pass and
    weights, ``examples/train_lm_curated.py:41-46``)."""
    example = _jax_example()
    assert curated.PRESETS == example.PRESETS
    cfg, step, k = configs.get_reduced(ARCH), 3, 8
    params = _jax_params(configs_j())
    model = _port_model(params, cfg)
    batch, emb = curated.embed_pool(cfg, model, step, device="cpu")
    jbatch = jdata.synthetic_batch(configs_j(), 64, 32, 10_000 + step)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(jbatch["tokens"]))
    logits, _ = jax.jit(lambda p, t: JM.forward(configs_j(), p, {
        "tokens": t}))(params, jbatch["tokens"])
    jemb = np.asarray(jnp.mean(logits, axis=1).astype(jnp.float32))
    np.testing.assert_allclose(emb.numpy(), jemb, rtol=0,
                               atol=1e-5 * np.abs(jemb).max())

    fit = JBanditPAM(k, metric="cosine", seed=step, baseline="leader").fit(
        jnp.asarray(jemb))
    _, _, jassign = jmedoid_cache(jnp.asarray(jemb), jnp.asarray(fit.medoids),
                                  metric="cosine")
    sizes = np.bincount(np.asarray(jassign), minlength=k).astype(np.float32)
    jw = 1.0 / sizes[np.asarray(jassign)]
    jw = jw / jw.sum()

    medoids, assign, w = curated.cluster_weights(
        torch.from_numpy(jemb.copy()), k, step)
    np.testing.assert_array_equal(medoids, np.asarray(fit.medoids))
    np.testing.assert_array_equal(assign, np.asarray(jassign))
    np.testing.assert_array_equal(w, jw)
    assert w.dtype == np.float32 and len(set(assign.tolist())) == k
    # And through the driver's entry point on the port's own embeddings.
    _, w2 = curated.curate_weights(cfg, model, step, device="cpu")
    assert w2.shape == (64,) and abs(float(w2.sum()) - 1.0) < 1e-6
