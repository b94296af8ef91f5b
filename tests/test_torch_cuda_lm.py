"""The LM curation path on the card: the reduced model on the card
against the CPU from the same weights, the fault loop's exact replay on
the card, and the four kernels the curation launches (``build_g``,
``swap_g``, ``top2``, ``pairwise``) at its feature width, d = 151,936 (qwen3-1.7B's
vocabulary: a point is a sequence's mean logits), cosine, against their
plain versions.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device (decided inside the fixture, never at import).  Run on the
card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_lm.py``.

Serving (``repro_torch.serve.lm``): prefill and greedy decode on the card
against the CPU at reduced width, for the ``global``, ``local`` (a
prompt of 24 over a window of 16: the cache rolls) and ``chunked`` kinds
and the MoE (arctic top-2 with the dense residual, llama4 top-1 with the
shared expert), Mamba-1 (falcon-mamba) and hybrid (zamba2: Mamba-2 and
the shared attention block) families, decode logits within
1e-5·max|logits| and the greedy tokens equal; and one decode step of
each family under ``torch.cuda.set_sync_debug_mode("error")``, which
raises on any synchronisation.

Tolerances: the logits within 1e-5·max|logits| and the losses within
rtol 1e-5 (``chip_smoke.py`` phase 12 (e)).  A float32 dot product over
d terms errs by at most d·2^-24 of its magnitude (``chip_smoke.py``
phase 3's derivation, 1e-4·dmax at d = 784), but at d = 151,936 that is
1 % of a distance, so a kernel's distance is held to how rounding errors
grow, ``tol = 4·sqrt(d)·2^-24·dmax``, and a sum over r reference rows
within ``r·tol`` (Σg), ``2·dmax·r·tol`` (BUILD's Σg², Σg·g_lead), twice
those in SWAP; every top-2 label names a medoid within ``tol`` of the
nearest plain distance.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.distributed import MedoidCurator
from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
from repro_torch.models import model as M
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.fault import FaultTolerantLoop
from repro_torch.serve import lm
from repro_torch.train import curated, init_opt_state, make_train_step
from repro_torch.train.data import synthetic_batch

pytestmark = pytest.mark.gpu

ARCH = "qwen3_1_7b"
N, D, K = 64, 151_936, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.set_float32_matmul_precision(old)


def test_reduced_model_card_matches_cpu(cuda):
    cfg = get_reduced(ARCH)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = synthetic_batch(cfg, 2, 32, 0, device="cpu")["tokens"]
    with torch.no_grad():
        want = cpu({"tokens": toks})[0]
        got = card({"tokens": toks.to(cuda)})[0].cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    losses = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        st = init_opt_state(M.params_of(model), curated.OPT)
        step = make_train_step(cfg, curated.OPT)
        losses[name] = []
        for i in range(3):
            _, st, m = step(model, st, synthetic_batch(cfg, 2, 32, i,
                                                       device=dev))
            losses[name].append(float(m["loss"]))
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-5)
    # The synthetic batches are the same on both devices.
    b = synthetic_batch(cfg, 2, 32, 7, device=cuda)
    assert torch.equal(b["tokens"].cpu(),
                       synthetic_batch(cfg, 2, 32, 7, device="cpu")["tokens"])


def _run(cfg, dev, ckpt_dir, fail_at=None):
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    step_fn = make_train_step(cfg, curated.OPT)
    failed = []

    def one_step(st, i):
        M.load_params(model, st["params"])
        if i == fail_at and not failed:
            failed.append(i)
            raise RuntimeError("transient")
        _, opt, m = step_fn(model, st["opt"],
                            synthetic_batch(cfg, 8, 64, i, device=dev))
        return {"params": M.params_of(model), "opt": opt}, m

    loop = FaultTolerantLoop(str(ckpt_dir), save_every=2,
                             install_sigterm=False)
    state = {"params": M.params_of(model),
             "opt": init_opt_state(M.params_of(model), curated.OPT)}
    return loop.run(state, one_step, n_steps=6)


def test_fault_loop_replays_exactly_on_the_card(cuda, tmp_path):
    cfg = curated.preset_config("cpu-small")
    want = ckpt._flatten(_run(cfg, cuda, tmp_path / "a"))
    got = ckpt._flatten(_run(cfg, cuda, tmp_path / "b", fail_at=3))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(torch.equal(g, w) for (_, g), (_, w) in zip(got, want))


def _embeddings(dev):
    """Points like the curation's: a shared direction plus each point's
    own, so cosine distances spread over (0, 1)."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(D).astype(np.float32)
    own = rng.standard_normal((N, D)).astype(np.float32)
    return torch.from_numpy(base + 0.8 * own).to(dev)


def _check(got, want, atol, rtol=1e-5):
    err = (got.double() - want.double()).abs()
    assert bool((err <= atol + rtol * want.double().abs()).all()), float(
        err.max())


def test_kernels_at_the_curation_width(cuda):
    x = _embeddings(cuda)
    y = x                                       # the batch: every row
    med = x[torch.arange(0, N, N // K, device=cuda)].contiguous()
    dmax = float(pairwise.pairwise_torch(x, y, metric="cosine").max())
    tol = 4.0 * math.sqrt(D) * 2.0 ** -24 * dmax
    lim = N * tol
    w = torch.ones(N, device=cuda)
    w[-5:] = 0.0
    dxy = pairwise.pairwise_torch(y, med, metric="cosine")
    dn = dxy.min(dim=1).values.contiguous()
    lg = (torch.clamp_max(dxy[:, 0] - dn, 0.0) * w).contiguous()
    before = ops.launch_counts()
    for g, wv, a in zip(ops.build_g_stats(x, y, dn, w, lg, metric="cosine"),
                        build_g.build_g_torch(x, y, dn, w, lg, "cosine"),
                        (lim, 2 * dmax * lim, 2 * dmax * lim)):
        _check(g, wv, a)
    d1, d2, a = stream_g.top2_torch(y, med, "cosine")
    lg2 = dxy[:, 0].contiguous()
    for g, wv, at in zip(
            ops.swap_g_stats(x, y, d1, d2, a, w, K, lg2, metric="cosine"),
            swap_g.swap_g_torch(x, y, d1, d2, a, w, K, lg2, "cosine"),
            (2 * lim, 4 * dmax * lim, 4 * dmax * lim)):
        _check(g, wv, at)
    got = ops.stream_top2(x, med, metric="cosine")
    want = stream_g.top2_torch(x, med, "cosine")
    _check(got[0], want[0], tol)
    _check(got[1], want[1], tol)
    clear = (want[1] - want[0]) > 2 * tol
    assert bool((got[2] == want[2])[clear].all())
    named = pairwise.pairwise_torch(x, med, metric="cosine").gather(
        1, got[2].long()[:, None])[:, 0]
    _check(named, want[0], tol)
    lead = x[:1].contiguous()                   # a leader's row
    _check(ops.pairwise_distance(lead, y, "cosine"),
           pairwise.pairwise_torch(lead, y, metric="cosine"), tol)
    after = ops.launch_counts()
    assert all(after[k] == before[k] + 1 for k in ("build_g", "swap_g",
                                                     "top2", "pairwise"))


def test_curation_cuda_matches_torch_at_a_wide_pool(cuda):
    """The cosine leader fit and its top-2 pass on the kernels against
    the plain path on the card, over one set of embeddings of the
    curation's width."""
    emb = _embeddings(cuda)
    ops.reset_launch_counts()
    med_c, assign_c = MedoidCurator(K, metric="cosine", seed=0,
                                    backend="cuda", device=cuda).curate(emb)
    assert ops.launch_counts()["top2"] >= 1
    med_t, assign_t = MedoidCurator(K, metric="cosine", seed=0,
                                    backend="torch", device=cuda).curate(emb)
    np.testing.assert_array_equal(med_c, med_t)
    np.testing.assert_array_equal(assign_c, assign_t)
    # The driver's default route is the kernels: its weights are theirs.
    med, assign, w = curated.cluster_weights(emb, K, 0)
    np.testing.assert_array_equal(med, med_c)
    np.testing.assert_array_equal(assign, assign_c)
    sizes = np.bincount(assign_c, minlength=K).astype(np.float32)
    np.testing.assert_allclose(w, (1.0 / sizes[assign_c]) / np.sum(
        1.0 / sizes[assign_c]), rtol=1e-6)


FAMILIES = (("arctic_480b", 12), ("llama4_scout_17b", 28),
            ("falcon_mamba_7b", 12), ("zamba2_2_7b", 12))


@pytest.mark.parametrize("arch,prompt", [("qwen3_1_7b", 32),
                                         ("gemma3_12b", 24),
                                         ("chunked", 28), *FAMILIES])
def test_decode_card_matches_cpu(cuda, arch, prompt):
    if arch == "chunked":
        cfg = dataclasses.replace(get_reduced("qwen3_1_7b"),
                                  name="chunked-reduced",
                                  layer_pattern=("chunked",), window=16)
    else:
        cfg = get_reduced(arch)
    steps = 12
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = synthetic_batch(cfg, 2, prompt, 0, device="cpu")["tokens"]
    out = {}
    for name, model, dev in (("cpu", cpu, torch.device("cpu")),
                             ("card", card, cuda)):
        logits, state = lm.make_prefill_step(cfg, prompt + steps + 1)(
            model, {"tokens": toks.to(dev)})
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens, _ = lm.greedy_decode(cfg, model, state, first, prompt, steps)
        out[name] = (logits.cpu(), first.cpu(), tokens.cpu())
    lim = 1e-5 * float(out["cpu"][0].abs().max())
    assert float((out["card"][0] - out["cpu"][0]).abs().max()) <= lim
    assert torch.equal(out["card"][1], out["cpu"][1])
    assert torch.equal(out["card"][2], out["cpu"][2])
    # Teacher-forced decode logits, card against CPU, every step.
    seq = torch.cat([out["cpu"][1], out["cpu"][2]], dim=1)
    states, step = {}, lm.make_decode_step(cfg)
    for name, model, dev in (("cpu", cpu, torch.device("cpu")),
                             ("card", card, cuda)):
        states[name] = lm.make_prefill_step(cfg, prompt + steps + 1)(
            model, {"tokens": toks.to(dev)})[1]
    for i in range(steps):
        got = {}
        for name, model, dev in (("cpu", cpu, torch.device("cpu")),
                                 ("card", card, cuda)):
            lg, states[name] = step(model, states[name],
                                    {"tokens": seq[:, i:i + 1].to(dev)},
                                    torch.tensor(prompt + i, device=dev))
            got[name] = lg.cpu()
        lim = 1e-5 * float(got["cpu"].abs().max())
        assert float((got["card"] - got["cpu"]).abs().max()) <= lim, i


@pytest.mark.parametrize("arch,prompt", FAMILIES)
def test_decode_step_does_not_sync(cuda, arch, prompt):
    """After a prefill, a decode step of each family (MoE dispatch, the
    SSM recurrences, the shared block) reads nothing back from the card:
    under sync debug mode "error" any synchronisation raises."""
    cfg = get_reduced(arch)
    model = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    toks = synthetic_batch(cfg, 2, prompt, 0, device=cuda)["tokens"]
    logits, state = lm.make_prefill_step(cfg, prompt + 4)(model,
                                                          {"tokens": toks})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.full((), prompt, dtype=torch.int64, device=cuda)
    step = lm.make_decode_step(cfg)
    step(model, state, {"tokens": tok}, pos)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = step(model, state, {"tokens": tok}, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(lg).all())
