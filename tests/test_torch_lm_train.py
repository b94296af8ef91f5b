"""The port's LM training (``repro_torch.train.optimizer``,
``train_step``, ``runtime.fault``) held against the live JAX package on
the CPU at ``get_reduced("qwen3_1_7b")``, B = 2, L = 32, on the same
numpy parameters, gradients and optimizer state; the loss and gradients
also at the reduced MoE (arctic, llama4), Mamba-1 (falcon-mamba) and
hybrid (zamba2) configs, the MoE loss with its load-balancing term, and
at the two frontends' (phi-3-vision's loss masked over its patches,
through ``vision_proj``; musicgen's the mean over its codebooks).

AdamW's first step moves a weight by about ``lr·sign(g)``, so a
gradient that is +1e-9 in one package and -1e-9 in the other moves it by
2·lr: the optimizer is held on its own (``apply_updates`` on equal
inputs: parameters, moments, ``grad_norm`` and ``lr`` within 1e-6
relative), the gradients on their own (rtol 1e-4, atol 1e-6), and a few
train steps by their losses (rtol 1e-4).  The fault loop's four JAX
tests (``tests/test_runtime.py``) are restated for the port, and a
model's run with one injected failure replays an uninterrupted run bit
for bit.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import synthetic_batch as jsynthetic_batch
from repro.train import train_step as jtrain
from repro_torch import configs, convert
from repro_torch.models import model as M
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.fault import (FaultTolerantLoop, Preemption,
                                       StragglerMonitor)
from repro_torch.train import curated, optimizer, train_step
from repro_torch.train import synthetic_batch
from torch_threads import one_intra_op_thread  # noqa: F401

ARCH = "qwen3_1_7b"
BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True)
def _highest_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(old)


def _cfgs():
    return configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return convert.lm_params_from_reference(_np(tree), device="cpu")


def _model_from(params, cfg=None):
    model = M.init_params(cfg or _cfgs()[0], device="cpu")
    model.load_state_dict(_port(params))
    return model


def _rel_close(got, want, rtol=1e-6):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _tree_close(got, want, rtol):
    assert got.keys() == want.keys()
    for k in want:
        _rel_close(got[k], want[k].float().numpy(), rtol)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

CASES = {
    # step count, gradient entries' scale (‖g‖ ≈ 330·scale, clipped past
    # 1), moment dtype
    "step 0": (0, 1e-4, "float32"),
    "past warm-up, clipped": (25, 10.0, "float32"),
    "bfloat16 moments": (0, 1e-4, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_updates_matches_jax(case):
    step, gscale, mdt = CASES[case]
    _, jcfg = _cfgs()
    ocfg = dict(lr=3e-3, warmup_steps=20, moment_dtype=mdt)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(step)
    grads = tdef.unflatten([gscale * rng.standard_normal(p.shape).astype(
        np.float32) for p in leaves])
    state = jopt.init_opt_state(params, jopt.OptConfig(**ocfg))
    if step:        # moments a run would hold: m ~ g, v ~ g² > 0
        state = {"m": tdef.unflatten([0.01 * rng.standard_normal(p.shape)
                                      .astype(np.float32) for p in leaves]),
                 "v": tdef.unflatten([1e-4 * rng.random(p.shape).astype(
                     np.float32) for p in leaves]),
                 "step": jnp.int32(step)}
    jp, js, jm = jax.jit(lambda p, g, s: jopt.apply_updates(
        p, g, s, jopt.OptConfig(**ocfg)))(params, grads, state)

    pp = _port(params)
    ps = convert.opt_state_from_reference(_np(state), device="cpu")
    assert ps["m"]["embed.weight"].dtype == getattr(torch, mdt)
    pp2, ps2, pm = optimizer.apply_updates(pp, _port(grads), ps,
                                           optimizer.OptConfig(**ocfg))
    assert pp2 is pp and int(ps2["step"]) == int(js["step"]) == step + 1
    _tree_close(pp2, _port(jp), 1e-6)
    _tree_close(ps2["m"], convert.lm_params_from_reference(
        _np(js["m"]), device="cpu"), 1e-6)
    _tree_close(ps2["v"], convert.lm_params_from_reference(
        _np(js["v"]), device="cpu"), 1e-6)
    _rel_close(pm["grad_norm"], jm["grad_norm"])
    _rel_close(pm["lr"], jm["lr"])
    assert (float(jm["grad_norm"]) > 1.0) == (gscale > 1.0)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _jax_grads(jcfg, params, batch, microbatches):
    """The JAX train step's loss and gradients (its ``grad_fn`` and, for
    several microbatches, its scan: ``train_step.py:63-72``)."""
    grad_fn = jax.value_and_grad(lambda p, b: jtrain.loss_fn(jcfg, p, b),
                                 has_aux=True)
    if microbatches == 1:
        (loss, _), grads = grad_fn(params, batch)
        return loss, grads
    mbs = jax.tree.map(lambda x: x.reshape(microbatches, -1, *x.shape[1:]),
                       batch)

    def body(carry, mb):
        g_acc, l_acc = carry
        (l, _), g = grad_fn(params, mb)
        return (jax.tree.map(jnp.add, g_acc, g), l_acc + l), None

    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    (g_sum, l_sum), _ = jax.lax.scan(body, (zeros, jnp.float32(0.0)), mbs)
    return l_sum / microbatches, jax.tree.map(lambda g: g / microbatches,
                                              g_sum)


FAMILIES = ("arctic_480b", "llama4_scout_17b", "falcon_mamba_7b",
            "zamba2_2_7b", "phi3_vision_4_2b", "musicgen_large")


@pytest.mark.parametrize("microbatches,arch", [
    pytest.param(1, ARCH, id="1"), pytest.param(2, ARCH, id="2"),
    *(pytest.param(mb, a, id=f"{a}-{mb}") for a in FAMILIES
      for mb in (1, 2))])
def test_loss_and_gradients_match(microbatches, arch):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    batch = synthetic_batch(cfg, BATCH, SEQ, 5, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jloss, jgrads = jax.jit(lambda p, b: _jax_grads(jcfg, p, b, microbatches))(
        params, jbatch)
    model = _model_from(params, cfg)
    loss, aux, grads = train_step.accumulate_grads(cfg, model, batch,
                                                   microbatches)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    if cfg.n_experts and microbatches == 1:
        # The JAX loss_fn's own split of the loss.
        _, jaux = jtrain.loss_fn(jcfg, params, jbatch)
        np.testing.assert_allclose(float(aux["aux"]), float(jaux["aux"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                                   rtol=1e-4)
    else:
        assert float(aux["ce"]) == float(loss) and float(aux["aux"]) == 0.0
    want = _port(jgrads)
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # loss_fn alone on the whole batch, and the eval step.
    if microbatches == 1:
        ev = train_step.make_eval_step(cfg)(model, batch)
        np.testing.assert_allclose(float(ev["loss"]), float(jloss), rtol=1e-4)


def test_train_steps_match():
    cfg, jcfg = _cfgs()
    ocfg = dict(lr=3e-3, warmup_steps=20)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jstate = jopt.init_opt_state(params, jopt.OptConfig(**ocfg))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt.OptConfig(**ocfg)))
    model = _model_from(params)
    state = optimizer.init_opt_state(M.params_of(model),
                                     optimizer.OptConfig(**ocfg))
    step = train_step.make_train_step(cfg, optimizer.OptConfig(**ocfg))
    for i in range(3):
        params, jstate, jm = jstep(params, jstate,
                                   jsynthetic_batch(jcfg, BATCH, SEQ, i))
        _, state, m = step(model, state, synthetic_batch(cfg, BATCH, SEQ, i,
                                                         device="cpu"))
        assert m.keys() == jm.keys()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(state["step"]) == 3


# ---------------------------------------------------------------------------
# the fault-tolerant loop (tests/test_runtime.py:129-175, restated)
# ---------------------------------------------------------------------------

def test_fault_loop_resumes_after_transient_failure(tmp_path):
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 3 and calls["n"] == 4:      # fail once at step 3
            raise RuntimeError("transient")
        return {"x": state["x"] + 1}, {"loss": 0.0}

    loop = FaultTolerantLoop(str(tmp_path), save_every=2,
                             install_sigterm=False)
    out = loop.run({"x": torch.tensor(0.0)}, step_fn, n_steps=6)
    assert float(out["x"]) == 6.0              # deterministic replay => exact


def test_fault_loop_preemption_checkpoints(tmp_path):
    loop = FaultTolerantLoop(str(tmp_path), save_every=100,
                             install_sigterm=False)

    def step_fn(state, step):
        if step == 2:
            loop._preempted = True             # simulate SIGTERM delivery
        return {"x": state["x"] + 1}, {}

    with pytest.raises(Preemption):
        loop.run({"x": torch.tensor(0.0)}, step_fn, n_steps=10)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored, _ = ckpt.restore(str(tmp_path), {"x": torch.tensor(0.0)})
    assert float(restored["x"]) == 3.0


def test_restore_or_fast_forwards(tmp_path):
    loop = FaultTolerantLoop(str(tmp_path), save_every=2,
                             install_sigterm=False)
    loop.run({"x": torch.tensor(0.0)},
             lambda s, i: ({"x": s["x"] + 1}, {}), n_steps=4)
    # new loop instance (fresh process after failure)
    loop2 = FaultTolerantLoop(str(tmp_path), save_every=2,
                              install_sigterm=False)
    restored, start = loop2.restore_or({"x": torch.tensor(0.0)})
    assert start == 4 and float(restored["x"]) == 4.0


def test_straggler_monitor():
    mon = StragglerMonitor(factor=2.0)
    for _ in range(5):
        for host in range(8):
            mon.record(host, 1.0 if host != 3 else 5.0)
    assert mon.stragglers() == [3]


class _FailsHalfway(dict):
    """A parameter mapping whose walk raises after half its leaves: an
    ``apply_updates`` that fails with some parameters and moments
    already written in place."""

    def items(self):
        for j, kv in enumerate(super().items()):
            if j == len(self) // 2:
                raise RuntimeError("transient, mid-update")
            yield kv


def _train(cfg, ckpt_dir, fail_at=None, n_steps=6, mid_update=False):
    """``n_steps`` train steps of a seeded model under the loop
    (``save_every=2``), one transient failure at ``fail_at``: before the
    step, or with ``mid_update`` inside its optimizer update."""
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    step_fn = train_step.make_train_step(cfg, curated.OPT)
    failed = []

    def half_update(params, grads, opt_state, cfg_):
        return optimizer.apply_updates(_FailsHalfway(params), grads,
                                       opt_state, cfg_)

    def one_step(st, i):
        M.load_params(model, st["params"])
        fail = i == fail_at and not failed
        if fail:
            failed.append(i)
            if not mid_update:
                raise RuntimeError("transient")
        batch = synthetic_batch(cfg, BATCH, SEQ, i, device="cpu")
        with mock.patch.object(train_step, "apply_updates",
                               half_update if fail else
                               optimizer.apply_updates):
            _, opt, m = step_fn(model, st["opt"], batch)
        return {"params": M.params_of(model), "opt": opt}, m

    loop = FaultTolerantLoop(str(ckpt_dir), save_every=2,
                             install_sigterm=False)
    state = {"params": M.params_of(model),
             "opt": optimizer.init_opt_state(M.params_of(model), curated.OPT)}
    return loop.run(state, one_step, n_steps=n_steps), loop


@pytest.mark.parametrize("fail_at,mid_update", [(3, False), (1, True)],
                         ids=["before the step", "inside the first update"])
def test_model_replay_after_a_failure_is_exact(tmp_path, fail_at,
                                               mid_update):
    """A failure at step 1 lands before the loop's first periodic
    checkpoint (step 2), half-way through the update's in-place writes:
    the retry must not replay that step on top of them."""
    cfg = configs.get_reduced(ARCH)
    want, _ = _train(cfg, tmp_path / "a")
    got, loop = _train(cfg, tmp_path / "b", fail_at=fail_at,
                       mid_update=mid_update)
    flat_w, flat_g = ckpt._flatten(want), ckpt._flatten(got)
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    assert all(torch.equal(g, w) for (_, g), (_, w) in zip(flat_g, flat_w))
    restored, start = loop.restore_or(want)
    assert start == 6 and all(
        torch.equal(r, w) for (_, r), (_, w) in zip(ckpt._flatten(restored),
                                                    flat_w))


def test_curated_main_runs_on_the_cpu(tmp_path, capsys):
    """The driver end to end at the cpu-small preset on the plain path:
    4 steps, with curation at steps 0 and 2."""
    argv = ["--preset", "cpu-small", "--steps", "4", "--curate-every", "2",
            "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    curated.main(argv)
    out = capsys.readouterr().out
    assert out.count("[curate]") == 2 and "done: 4 steps" in out
