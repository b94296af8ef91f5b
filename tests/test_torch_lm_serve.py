"""The port's LM serving (``repro_torch.models`` decode state,
``repro_torch.serve.lm``, ``repro_torch.launch.serve``,
``convert.lm_state_from_reference``) held against the live JAX package on
the CPU, from the same weights (the JAX ``init_params``, carried across
by ``convert.lm_params_from_reference``) and the same prompts
(``synthetic_batch``), at reduced widths:

* ``qwen3_1_7b`` reduced: two ``global`` layers, the cache longer than
  the prompt (zero slots after it);
* ``gemma3_12b`` reduced: five ``local`` layers (window 16) and one
  ``global``, with a prompt of 8 (the local cache not yet full) and of
  24 (the local cache rolled by ``24 % 16``);
* a reduced config whose ``layer_pattern`` is ``("chunked",)``, window
  16, with a prompt of 28: decoding crosses the chunk boundary at 32;
* ``arctic_480b`` reduced: MoE top-2 with the dense residual MLP, a
  prompt of 12;
* ``llama4_scout_17b`` reduced: MoE top-1 with the shared expert, three
  ``chunked`` layers (window 32) and a ``global`` one, a prompt of 28
  (decoding crosses the chunk boundary at 32).  The prefill routes
  B·L = 56 tokens at 24 slots an expert, so assignments may be dropped
  there as in the JAX layer; a decode step routes B = 2 tokens at 8;
* ``falcon_mamba_7b`` reduced: two Mamba-1 layers, a prompt of 12;
* ``zamba2_2_7b`` reduced: five Mamba-2 layers and a sixth followed by
  the shared attention block, a prompt of 12;
* ``phi3_vision_4_2b`` reduced: a prompt of 20 positions, 8 projected
  patch embeddings then 12 text tokens; decode is text only from
  position 20;
* ``musicgen_large`` reduced: 2 codebooks, a prompt of 12 steps, greedy
  decode per codebook ([B, 1, 2] tokens, [B, 1, 2, V] logits).

Each decode runs until at least 6 steps past the window.  Tolerances:
logits within 1e-5·max|logits| (the forward's standard,
``tests/test_torch_lm.py``); attention outputs and the first layer's
caches within rtol 1e-5, atol 1e-6 (float32 ops that XLA and PyTorch may
round or order differently in the last bits); the deeper layers' caches
within rtol 1e-5 and the logits' standard, atol 1e-5·max|leaf|: their
keys and values carry the earlier layers' last-bit differences, measured
up to 1.4e-6·max|leaf| (4.1e-6 absolute at gemma3's sixth layer), which
passes 1e-6 on entries near 0 by up to 2.4 times; positions, masks and
tokens exactly.  The float32 matmul precision is pinned to "highest".
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import lm as jlm
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import lm
from repro_torch.train import data
from torch_threads import one_intra_op_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BATCH = 2
WINDOW_PAST = 6

# name -> (arch, prompt length); "chunked" is qwen3's reduced config with
# one chunked layer kind.
CASES = {"global": ("qwen3_1_7b", 12), "local_short": ("gemma3_12b", 8),
         "local_rolled": ("gemma3_12b", 24), "chunked": ("chunked", 28),
         "moe_arctic": ("arctic_480b", 12),
         "moe_llama4": ("llama4_scout_17b", 28),
         "mamba1": ("falcon_mamba_7b", 12), "hybrid": ("zamba2_2_7b", 12),
         "vision": ("phi3_vision_4_2b", 20), "audio": ("musicgen_large", 12)}
FAMILIES = ("arctic_480b", "llama4_scout_17b", "falcon_mamba_7b",
            "zamba2_2_7b", "phi3_vision_4_2b", "musicgen_large")


@pytest.fixture(autouse=True)
def _highest_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(old)


def _configs(arch):
    if arch == "chunked":
        kw = dict(name="chunked-reduced", layer_pattern=("chunked",),
                  window=16)
        return (dataclasses.replace(configs.get_reduced("qwen3_1_7b"), **kw),
                dataclasses.replace(jconfigs.get_reduced("qwen3_1_7b"), **kw))
    return configs.get_reduced(arch), jconfigs.get_reduced(arch)


def _steps(cfg, prompt):
    """Decode steps that end at least WINDOW_PAST past the window (past
    the prompt where the window is wider than the run)."""
    if cfg.window > prompt + 64:
        return WINDOW_PAST
    return max(WINDOW_PAST, cfg.window + WINDOW_PAST - prompt)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _state_close(got, want):
    """Leaf for leaf; the first layer's caches (group 0 of pattern
    position 0) within rtol 1e-5, atol 1e-6, every cache within rtol 1e-5
    and atol 1e-5·max|leaf| (module docstring)."""
    assert len(got) == len(want)
    for j, (g_kv, w_kv) in enumerate(zip(got, want)):
        for g, w in zip(g_kv, w_kv):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            if j == 0:
                _close(g[0], w[0])
            _close(g, w, atol=1e-5 * np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _setup(case):
    """Both models on the same weights, the prompts (``tokens``, and a
    vision prompt's ``patch_emb``; ``prompt`` counts every position), and
    the JAX run: prefill (last logits, state), then the teacher-forced
    decode of the JAX greedy tokens (each step's logits and state)."""
    arch, prompt = CASES[case]
    cfg, jcfg = _configs(arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = M.init_params(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu"))
    steps = _steps(cfg, prompt)
    cache_len = prompt + steps + 1
    full = data.synthetic_batch(cfg, BATCH, prompt, 0, device="cpu")
    prompts = {k: full[k] for k in ("tokens", "patch_emb") if k in full}
    jprefill = jax.jit(jlm.make_prefill_step(jcfg, cache_len=cache_len))
    jdecode = jax.jit(jlm.make_decode_step(jcfg))
    logits, state = jprefill(params, {k: jnp.asarray(v.numpy())
                                      for k, v in prompts.items()})
    run = [(np.asarray(logits), jax.tree.map(np.asarray, state))]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    tokens = []
    for i in range(steps):
        tokens.append(np.array(tok))
        logits, state = jdecode(params, state, {"tokens": tok},
                                jnp.int32(prompt + i))
        run.append((np.asarray(logits), jax.tree.map(np.asarray, state)))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    return cfg, jcfg, params, model, prompts, prompt, cache_len, run, tokens


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_decode_attention_matches_by_kind(kind):
    """A rolled cache of 12 slots at position 29 (slots holding 18..29)
    and a part-filled one at position 5 (slots 6.. empty), window 8 and
    8-position chunks; GQA 4 heads over 2."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((BATCH, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((BATCH, 12, 2, 16)).astype(np.float32)
              for _ in range(2))
    for pos in (29, 5):
        epos = np.asarray(JM._entry_positions(12, jnp.int32(pos)))[None, :]
        want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(epos),
                                   jnp.int32(pos), kind=kind, window=8)
        got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 torch.from_numpy(epos.astype(np.int64)),
                                 torch.tensor(pos), kind=kind, window=8)
        assert got.shape == (BATCH, 1, 4, 16)
        _close(got, want)


@pytest.mark.parametrize("s_c,pos", [(16, 0), (16, 15), (16, 37), (7, 100)])
def test_entry_positions_and_cache_len(s_c, pos):
    want = np.asarray(JM._entry_positions(s_c, jnp.int32(pos)))
    got = M._entry_positions(s_c, torch.tensor(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    cfg, jcfg = _configs("gemma3_12b")
    for kind in ("global", "local", "chunked"):
        assert M._cache_len(cfg, kind, s_c + pos) == JM._cache_len(
            jcfg, kind, s_c + pos)


@pytest.mark.parametrize("l,s_c", [(10, 16), (16, 16), (24, 16), (37, 8)])
def test_fill_kv_cache_both_branches(l, s_c):
    """A cache as long as the prompt or longer pads; a shorter one keeps
    the prompt's last s_c positions rolled so that p sits in p % s_c."""
    rng = np.random.default_rng(l)
    k, v = (rng.standard_normal((BATCH, l, 2, 4)).astype(np.float32)
            for _ in range(2))
    want = JM._fill_kv_cache((jnp.asarray(k), jnp.asarray(v)), s_c, l)
    got = M._fill_kv_cache((torch.from_numpy(k), torch.from_numpy(v)), s_c, l)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if s_c < l:
        p = l - 1
        np.testing.assert_array_equal(got[0][:, p % s_c].numpy(), k[:, p])


def test_init_decode_state_layout():
    cfg, jcfg = _configs("gemma3_12b")
    want = JM.init_decode_state(jcfg, BATCH, 40, dtype=jnp.float32)
    got = M.init_decode_state(cfg, BATCH, 40, device="cpu")
    assert len(got) == len(want) == len(cfg.layer_pattern)
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk.shape == wk.shape and gv.shape == wv.shape
        assert gk.dtype == torch.float32 and not gk.any() and not gv.any()


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_decode_state_layout_by_family(arch):
    """One entry per pattern position and one more after a
    ``+shared_attn`` position's, leaf shapes and dtypes equal to the JAX
    layout's at the model dtype bfloat16 (the SSM ``h`` stays float32),
    every leaf zero."""
    cfg, jcfg = _configs(arch)
    want = JM.init_decode_state(jcfg, BATCH, 40, dtype=jnp.bfloat16)
    got = M.init_decode_state(cfg, BATCH, 40, dtype=torch.bfloat16,
                              device="cpu")
    assert len(got) == len(want) == len(M.state_kinds(cfg))
    for g_e, w_e in zip(got, want):
        for g, w in zip(g_e, w_e):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[1] == str(w.dtype)
            assert not g.any()


# ---------------------------------------------------------------------------
# prefill, decode, greedy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_state_matches_jax(case):
    cfg, _, _, model, prompts, _, cache_len, run, _ = _setup(case)
    logits, state = lm.make_prefill_step(cfg, cache_len)(model, prompts)
    assert logits.shape == (BATCH, 1) + ((cfg.n_codebooks,) if cfg.frontend
                                         == "audio_stub" else ()) + (
                                             cfg.vocab,)
    _logits_close(logits, run[0][0])
    _state_close(state, run[0][1])
    # The prefill's logits are the plain forward's.
    with torch.no_grad():
        plain = model(prompts)[0][:, -1:]
    assert torch.equal(logits, plain)


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_steps_match_jax(case, source):
    """Teacher-forced on the JAX greedy tokens, from the port's own
    prefill or from the JAX prefill's state carried across."""
    cfg, _, _, model, prompts, prompt, cache_len, run, tokens = _setup(case)
    if source == "port":
        _, state = lm.make_prefill_step(cfg, cache_len)(model, prompts)
    else:
        state = convert.lm_state_from_reference(run[0][1], device="cpu")
    step = lm.make_decode_step(cfg)
    for i, tok in enumerate(tokens):
        before = [t.clone() for kv in state for t in kv]
        logits, new = step(model, state, {"tokens": torch.from_numpy(tok)},
                           torch.tensor(prompt + i))
        # decode_step leaves its input state as it was.
        assert all(torch.equal(a, b) for a, b in
                   zip(before, [t for kv in state for t in kv]))
        state = new
        _logits_close(logits, run[i + 1][0])
        _state_close(state, run[i + 1][1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_decode_tokens_equal(case):
    """The greedy tokens equal the JAX loop's; every step's top-2 logit
    gap clears the logits' tolerance on both sides, so equal tokens are
    what the tolerance implies and not a coin toss."""
    (cfg, jcfg, params, model, prompts, prompt, cache_len, run,
     tokens) = _setup(case)
    _, state = lm.make_prefill_step(cfg, cache_len)(model, prompts)
    first = torch.from_numpy(tokens[0])
    got, _ = lm.greedy_decode(cfg, model, state, first, prompt,
                              len(tokens) - 1)
    want, _ = jlm.greedy_decode(jcfg, params, run[0][1],
                                jnp.asarray(tokens[0]), prompt,
                                len(tokens) - 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate(tokens[1:], axis=1))
    for logits, _ in run:
        top = np.sort(logits.reshape(-1, logits.shape[-1]), axis=1)
        tol = 1e-5 * np.abs(logits).max()
        assert (top[:, -1] - top[:, -2] > 2 * tol).all()


def test_serve_driver_runs_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "qwen3_1_7b", "--reduced",
                             "--requests", "3", "--prompt-len", "12",
                             "--max-new", "5", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "prefill:" in printed and "decode:" in printed
    assert out["tokens"].shape == (3, 5) and len(out["decode_s"]) == 4
    # The driver's tokens are greedy_decode's on its model and prompts.
    cfg = configs.get_reduced("qwen3_1_7b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = data.synthetic_batch(cfg, 3, 12, 0, device="cpu")["tokens"]
    logits, state = lm.make_prefill_step(cfg, 17)(model, {"tokens": toks})
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    rest, _ = lm.greedy_decode(cfg, model, state, first, 12, 4)
    np.testing.assert_array_equal(
        out["tokens"], torch.cat([first, rest], dim=1).numpy())


@pytest.mark.parametrize("arch", ["phi3_vision_4_2b", "musicgen_large"])
def test_serve_driver_serves_the_frontends(arch):
    """The driver's vision prompt is its 8 patches then 4 text tokens,
    decoded from position 12; audio's tokens are [B, steps, nc].  Its
    tokens are ``greedy_decode``'s on its model and prompts."""
    out = launch_serve.main(["--arch", arch, "--reduced", "--requests", "2",
                             "--prompt-len", "12", "--max-new", "4",
                             "--device", "cpu"])
    cfg = configs.get_reduced(arch)
    nc = (cfg.n_codebooks,) if cfg.frontend == "audio_stub" else ()
    assert out["tokens"].shape == (2, 4) + nc
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    full = data.synthetic_batch(cfg, 2, 12, 0, device="cpu")
    prompts = {k: full[k] for k in ("tokens", "patch_emb") if k in full}
    logits, state = lm.make_prefill_step(cfg, 16)(model, prompts)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    rest, _ = lm.greedy_decode(cfg, model, state, first, 12, 3)
    np.testing.assert_array_equal(
        out["tokens"], torch.cat([first, rest], dim=1).numpy())


def test_serve_driver_refuses_a_mesh(monkeypatch):
    """The driver no longer refuses several visible cards: its mesh comes
    from the ranks of the process group, and with one rank (no group)
    it serves as it does with one card (the mesh path runs on 4 gloo
    ranks in ``tests/test_torch_mesh_ranks.py``)."""
    argv = ["--arch", "qwen3_1_7b", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "8", "--max-new", "3"]
    want = launch_serve.main(argv)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = launch_serve.main(argv)
    assert got["tokens"].shape == (2, 3)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get_reduced("qwen3_1_7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_decode_state(cfg, BATCH, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "qwen3_1_7b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_state_from_reference(
            M.init_decode_state(cfg, BATCH, 16, device="cpu"))

