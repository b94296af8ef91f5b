"""The port's int8 error-feedback compression
(``repro_torch.distributed.compression``) and the compressed train step
(``repro_torch.train.compressed``) on the CPU, held against the JAX
package.

* ``quantize_int8`` / ``dequantize_int8`` equal the JAX functions bit
  for bit on the same numpy inputs; the JAX package's round-trip and
  error-feedback tests (``tests/test_distributed.py``) restated.
* ``models.model.reference_leaves`` groups the port's parameters as the
  JAX tree's leaves (a layer's tensor stacked over the layers of its
  pattern position), the grouping by which the step shares a scale.
* The JAX ``make_compressed_train_step`` runs ``STEPS`` steps of
  ``get_reduced("qwen3_1_7b")`` at B = 8, L = 32 on a mesh of 2
  simulated pods, in a subprocess started with the module.
* One spawned group of 2 ``gloo`` ranks (a free ``tcp://127.0.0.1``
  port, a timeout on the group and on the run) runs, once for the file:
  ``psum_int8_ef`` on the JAX test's input, held against a JAX replay
  (``quantize_int8`` on each rank's slice, the ``tensordot`` sum: the
  residuals equal, the sums within an ulp, since XLA:CPU's dot fuses
  the second product into the sum) and against the exact sum within
  ``max|sum| / 64 + 1e-5`` as the JAX test holds it; the tree form;
  the compressed step from the JAX weights, free-running (each step's
  loss and ``grad_norm`` against the JAX step's, rtol 1e-4, the LM
  tests' bound on a few train steps); one step from each JAX state; the
  step on a group of one rank against the plain step fed the
  quantize-then-dequantize gradients of each stacked leaf with the
  residual carried, equal bit for bit; and the compressed step from the
  port's own weights beside the port's uncompressed step: both converge
  and the last losses agree within 5 % (``tests/test_compressed_train.py``'s
  bound).
* The steps from each JAX state are held against the JAX step from the
  same state, in a second subprocess, fed each pod's gradient and loss
  as the port computed them (its ``loss_fn`` replaced by one with that
  value and gradient): int8 rounding is discontinuous, and the
  packages' gradients, within the LM tests' rtol 1e-4 / atol 1e-6 of
  each other (held here too), put a few elements a step on the other
  side of a rounding boundary.  On the same gradients the residuals are
  equal bit for bit, and the parameters, moments, loss and ``grad_norm``
  within 1e-6 relative (``apply_updates``' bound in the LM tests).
"""

import dataclasses
import datetime
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.distributed import compression as jcomp
from repro.models import model as JM
from repro_torch import configs, convert
from repro_torch.core.distributed import _free_port
from repro_torch.distributed import compression as comp
from repro_torch.models import model as M
from repro_torch.train import (OptConfig, apply_updates, init_opt_state,
                               make_train_step, synthetic_batch)
from repro_torch.train.compressed import (init_pod_residuals,
                                          make_compressed_train_step)
from repro_torch.train.train_step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3_1_7b"
WORLD = 2
STEPS = 8
BATCH, SEQ = 8, 32
OPT = dict(lr=5e-3, warmup_steps=2)
TIMEOUT = 300

# The JAX compressed step on WORLD simulated pods: argv[1] the pickle it
# writes, argv[2] the JSON of (arch, world, steps, batch, seq, opt).  It
# keeps the state before every step and each step's loss and grad_norm.
_JAX_STEPS = textwrap.dedent("""
    import json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.models import model as M
    from repro.train import OptConfig, init_opt_state, synthetic_batch
    from repro.train.compressed import (init_pod_residuals,
                                        make_compressed_train_step)
    arch, world, steps, batch, seq, opt = json.loads(sys.argv[2])
    mesh = jax.make_mesh((world,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    cfg, ocfg = get_reduced(arch), OptConfig(**opt)
    params = M.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    state = (params, init_opt_state(params, ocfg),
             init_pod_residuals(params, world))
    step = jax.jit(make_compressed_train_step(cfg, ocfg, mesh))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for i in range(steps):
        *state, m = step(*state, synthetic_batch(cfg, batch, seq, i))
        states.append(jax.tree.map(np.asarray, tuple(state)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    with open(sys.argv[1], "wb") as f:
        pickle.dump({"states": states, "metrics": metrics}, f)
""")


# The JAX compressed step from each of _JAX_STEPS' states, fed each
# pod's gradient and loss: argv[1] that script's pickle, argv[2] the
# pickle of one {"grad": tree [world, ...], "loss": [world]} a step,
# argv[3] the pickle it writes, argv[4] as _JAX_STEPS' argv[2].  It also
# keeps each pod's own gradient and loss at each state.
_JAX_FED = textwrap.dedent("""
    import json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.train.compressed as C
    from repro.configs import get_reduced
    from repro.train import OptConfig, synthetic_batch
    from repro.train.train_step import loss_fn
    arch, world, steps, batch, seq, opt = json.loads(sys.argv[4])
    with open(sys.argv[1], "rb") as f:
        states = pickle.load(f)["states"]
    with open(sys.argv[2], "rb") as f:
        fed = pickle.load(f)

    def fed_loss(cfg, params, batch):
        # The pod's given loss, with the given gradient.
        dot = sum(jnp.sum(p * g[0]) for p, g in zip(
            jax.tree.leaves(params), jax.tree.leaves(batch["grad"])))
        return batch["loss"][0] + (dot - jax.lax.stop_gradient(dot)), {}

    C.loss_fn = fed_loss
    mesh = jax.make_mesh((world,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    cfg, ocfg = get_reduced(arch), OptConfig(**opt)
    step = jax.jit(C.make_compressed_train_step(cfg, ocfg, mesh))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(cfg, p, b), has_aux=True))
    m = batch // world
    out = []
    for i in range(steps):
        b = synthetic_batch(cfg, batch, seq, i)
        own = [grad_fn(states[i][0], jax.tree.map(
            lambda x: x[p * m:(p + 1) * m], b)) for p in range(world)]
        *post, metrics = step(*states[i], fed[i])
        out.append({"post": jax.tree.map(np.asarray, tuple(post)),
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "own": [(float(l), jax.tree.map(np.asarray, g))
                            for (l, _), g in own]})
    with open(sys.argv[3], "wb") as f:
        pickle.dump(out, f)
""")


def _jax_env():
    return dict(os.environ,
                XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT / "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _args():
    return json.dumps([ARCH, WORLD, STEPS, BATCH, SEQ, OPT])


@pytest.fixture(autouse=True)
def _highest_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0), ((1000,), 1e-3),
                                         ((3, 5, 7), 250.0), ((17,), 0.0)])
def test_quantize_and_dequantize_equal_jax(shape, scale):
    """Exactly, halves included: ``x`` holds values that land on ``.5``
    after the division (round half to even in both packages)."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    if scale:
        flat[:4] = np.float32(np.abs(flat).max()) * np.float32(
            [1.0, -1.0, 0.5 / 127, 2.5 / 127])
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().view(np.int32) == np.asarray(js).view(np.int32)
    deq = comp.dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(
        deq.view(np.int32),
        np.asarray(jcomp.dequantize_int8(jq, js)).view(np.int32))


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    q, s = comp.quantize_int8(x)
    err = torch.max(torch.abs(comp.dequantize_int8(q, s) - x))
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_error_feedback_reduces_bias():
    """The accumulated dequantized sum stays within one quantum of the
    accumulated true sum: the difference is the last residual."""
    rng = np.random.default_rng(1)
    residual = comp.init_residuals({"g": torch.zeros(32)})["g"]
    acc_true, acc_q = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32)) * 0.01
        xr = g + residual
        q, s = comp.quantize_int8(xr)
        deq = comp.dequantize_int8(q, s)
        residual = xr - deq
        acc_true += g.numpy()
        acc_q += deq.numpy()
    assert np.max(np.abs(acc_true - acc_q)) <= float(s) + 1e-6


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "llama4_scout_17b",
                                  "zamba2_2_7b", "musicgen_large"])
def test_reference_leaves_are_the_jax_leaves(arch):
    """At twice the reduced depth (two layers at each pattern position):
    one group a JAX leaf, its tensors as many elements as the leaf."""
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    depth = 2 * len(cfg.layer_pattern)
    cfg = dataclasses.replace(cfg, n_layers=depth)
    jcfg = dataclasses.replace(jcfg, n_layers=depth)
    params = M.params_of(M.init_params(cfg, device="cpu"))
    leaves = M.reference_leaves(cfg, params)
    jleaves = jax.tree.leaves(jax.eval_shape(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0),
                               dtype=jnp.float32)))
    assert sorted(n for leaf in leaves for n in leaf) == sorted(params)
    assert sorted(sum(params[n].numel() for n in leaf) for leaf in leaves) \
        == sorted(int(np.prod(a.shape)) for a in jleaves)
    stacked = [leaf for leaf in leaves if leaf[0].startswith("layers.")]
    assert stacked and all(len(leaf) == 2 for leaf in stacked)


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """The JAX compressed step's states, computed in a subprocess with
    ``WORLD`` simulated devices while this module's in-process tests
    run; yields the pickle's path and the process."""
    path = tmp_path_factory.mktemp("jax_compressed") / "steps.pkl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_STEPS, str(path), _args()], cwd=ROOT,
        env=_jax_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_steps(jax_proc):
    path, proc = jax_proc
    _, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return path, pickle.load(f)


def _losses(step_fn, steps, cfg):
    out = []
    for i in range(steps):
        out.append(float(step_fn(synthetic_batch(cfg, BATCH, SEQ, i,
                                                 device="cpu"))))
    return out


def _model_and_opt(cfg):
    torch.manual_seed(0)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    return model, init_opt_state(M.params_of(model), OptConfig(**OPT))


def _from_jax(cfg, state, pod):
    """A model, its optimizer state and pod ``pod``'s residuals from a
    JAX ``(params, opt_state, residuals)`` state (numpy leaves)."""
    params, opt, res = state
    model = M.init_params(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(params,
                                                           device="cpu"))
    return (model, convert.opt_state_from_reference(opt, device="cpu"),
            convert.lm_params_from_reference(
                jax.tree.map(lambda r: r[pod], res), device="cpu"))


def _numpy(tree):
    return {k: v.detach().clone().numpy() for k, v in tree.items()}


def _replay_step(cfg, model, opt, residuals, batch):
    """The compressed step at one rank, written out: the plain gradient,
    each stacked leaf quantized and dequantized with the residual
    carried (``xr - q·s`` rounded once, in float64 where it is exact),
    then ``apply_updates``."""
    (loss, _), grads = value_and_grad(cfg, model, batch)
    deq = {}
    for leaf in M.reference_leaves(cfg, grads):
        xr = torch.stack([grads[n] + residuals[n] for n in leaf])
        q, s = comp.quantize_int8(xr)
        new = (xr.double() - q.double() * s.double()).float()
        for n, r, dn in zip(leaf, new, comp.dequantize_int8(q, s)):
            residuals[n].copy_(r)
            deq[n] = dn
    _, opt, om = apply_updates(M.params_of(model), {n: deq[n] for n in grads},
                               opt, OptConfig(**OPT))
    return opt, {"loss": loss, **om}


def _rank_main(rank, init, ref_path, queue):
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        out = {}
        # The JAX test's input: rank r holds rows [4r, 4r + 4) of x.
        x = torch.arange(2 * 4 * 16, dtype=torch.float32).reshape(8, 16)
        x = x * 0.01
        mine = x[4 * rank:4 * rank + 4]
        comp.reset_gather_counts()
        total, res = comp.psum_int8_ef(mine, torch.zeros_like(mine))
        out["gathers"] = {str(k): v for k, v in comp.gather_counts().items()}
        out.update(total=total.numpy(), exact=(x[:4] + x[4:]).numpy(),
                   res=res.numpy())
        # The tree form: each tensor its own scale, or one scale for a
        # leaf (psum_int8_ef of the stacked tensors).
        tree = {"a": mine, "b": -3 * mine}
        alone = {k: comp.psum_int8_ef(t, torch.zeros_like(t))
                 for k, t in tree.items()}
        both = comp.psum_int8_ef(torch.stack(list(tree.values())),
                                 torch.zeros(2, 4, 16))
        out["tree"] = []
        for leaves in (None, [("a", "b")]):
            tsum, tres = comp.tree_psum_int8_ef(dict(tree),
                                                comp.init_residuals(tree),
                                                leaves=leaves)
            want = ({k: a for k, a in alone.items()} if leaves is None else
                    {k: (both[0][i], both[1][i]) for i, k in enumerate(tree)})
            out["tree"].append(all(
                torch.equal(tsum[k], want[k][0])
                and torch.equal(tres[k], want[k][1]) for k in tree))

        cfg = configs.get_reduced(ARCH)
        step = make_compressed_train_step(cfg, OptConfig(**OPT))
        with open(ref_path, "rb") as f:
            states = pickle.load(f)["states"]

        # From the JAX weights, free-running.
        model, opt, res_t = _from_jax(cfg, states[0], rank)
        out["free"] = []
        for i in range(STEPS):
            model, opt, res_t, m = step(
                model, opt, res_t, synthetic_batch(cfg, BATCH, SEQ, i,
                                                   device="cpu"))
            out["free"].append((float(m["loss"]), float(m["grad_norm"])))

        # One step from each JAX state, with the gradient and loss this
        # pod computes there.
        out["forced"] = []
        for i in range(STEPS):
            model, opt, res_t = _from_jax(cfg, states[i], rank)
            batch = synthetic_batch(cfg, BATCH, SEQ, i, device="cpu")
            m = BATCH // WORLD
            (loss, _), grads = value_and_grad(
                cfg, model, {k: v[rank * m:(rank + 1) * m]
                             for k, v in batch.items()})
            model, opt, res_t, met = step(model, opt, res_t, batch)
            out["forced"].append({
                "pod_loss": float(loss), "grad": _numpy(grads),
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "params": _numpy(M.params_of(model)),
                "m": _numpy(opt["m"]), "v": _numpy(opt["v"]),
                "res": _numpy(res_t)})

        # At one rank against the replay, both from the JAX weights.
        groups = [dist.new_group([r]) for r in range(WORLD)]
        one = make_compressed_train_step(cfg, OptConfig(**OPT), groups[rank])
        a, a_opt, a_res = _from_jax(cfg, states[0], rank)
        b, b_opt, b_res = _from_jax(cfg, states[0], rank)
        out["replay"] = []
        for i in range(3):
            batch = synthetic_batch(cfg, BATCH, SEQ, i, device="cpu")
            a, a_opt, a_res, am = one(a, a_opt, a_res, batch)
            b_opt, bm = _replay_step(cfg, b, b_opt, b_res, batch)
            out["replay"].append(
                torch.equal(am["loss"], bm["loss"])
                and all(torch.equal(p, M.params_of(b)[k])
                        for k, p in M.params_of(a).items())
                and all(torch.equal(r, b_res[k]) for k, r in a_res.items())
                and all(torch.equal(a_opt[s][k], b_opt[s][k])
                        for s in ("m", "v") for k in a_opt[s]))

        # From the port's own weights, beside the uncompressed step.
        model, opt = _model_and_opt(cfg)
        state = {"opt": opt, "res": init_pod_residuals(M.params_of(model))}

        def one_step(batch):
            _, state["opt"], state["res"], m = step(model, state["opt"],
                                                    state["res"], batch)
            return m["loss"]

        comp.reset_gather_counts()
        out["losses"] = _losses(one_step, STEPS, cfg)
        out["n_leaves"] = len(M.reference_leaves(cfg, M.params_of(model)))
        out["step_gathers"] = {str(k): v
                               for k, v in comp.gather_counts().items()}
        out["param0"] = M.params_of(model)["final_norm.weight"].detach(
            ).numpy()
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(jax_steps):
    """Both ranks' results, from one spawned group for the file."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(init, str(jax_steps[0]), queue), nprocs=WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    out = {}
    try:
        while True:
            while not queue.empty():
                rank, value = queue.get()
                out[rank] = value
            if procs.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{WORLD} ranks ran past {TIMEOUT} s")
        while not queue.empty():
            rank, value = queue.get()
            out[rank] = value
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    assert sorted(out) == list(range(WORLD))
    return out


def _to_reference(tree, template):
    """The port's tensors by name (numpy) as the JAX tree shaped as
    ``template``: ``convert.lm_params_from_reference`` inverted, read
    off it by converting a tree of element indices."""
    leaves, tdef = jax.tree.flatten(template)
    sizes = [int(np.prod(np.shape(a))) for a in leaves]
    offs = np.cumsum([0] + sizes)
    index = tdef.unflatten([np.arange(o, o + n).reshape(np.shape(a))
                            for o, n, a in zip(offs, sizes, leaves)])
    flat = np.empty(offs[-1], np.float32)
    for k, ix in convert.lm_params_from_reference(index,
                                                  device="cpu").items():
        flat[ix.numpy().reshape(-1)] = tree[k].reshape(-1)
    return tdef.unflatten([flat[o:o + n].reshape(np.shape(a))
                           for o, n, a in zip(offs, sizes, leaves)])


@pytest.fixture(scope="module")
def jax_fed(jax_steps, gloo_run, tmp_path_factory):
    """The JAX step from each JAX state, fed the pods' gradients and
    losses from ``gloo_run`` (``_JAX_FED``)."""
    template = jax_steps[1]["states"][0][0]
    fed = []
    for i in range(STEPS):
        pods = [gloo_run[r]["forced"][i] for r in range(WORLD)]
        fed.append({
            "grad": jax.tree.map(lambda *g: np.stack(g), *[
                _to_reference(p["grad"], template) for p in pods]),
            "loss": np.float32([p["pod_loss"] for p in pods])})
    tmp = tmp_path_factory.mktemp("jax_fed")
    with open(tmp / "fed.pkl", "wb") as f:
        pickle.dump(fed, f)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FED, str(jax_steps[0]),
         str(tmp / "fed.pkl"), str(tmp / "out.pkl"), _args()], cwd=ROOT,
        env=_jax_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        return fed, pickle.load(f)


def _rel_close(got, want, rtol, atol_rel=None, err_msg=""):
    """Within ``rtol`` of ``want`` and ``atol_rel`` (``rtol`` when None)
    of its largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=(rtol if atol_rel is None else atol_rel)
                               * scale, err_msg=err_msg)


def test_psum_int8_ef_on_two_gloo_ranks(gloo_run):
    x = np.arange(128, dtype=np.float32).reshape(8, 16) * np.float32(0.01)
    # The JAX replay: each rank's slice quantized, the tensordot sum.
    qs = [jcomp.quantize_int8(jnp.asarray(x[4 * r:4 * r + 4]))
          for r in range(WORLD)]
    jtotal = np.asarray(jnp.tensordot(
        jnp.stack([s for _, s in qs]),
        jnp.stack([q for q, _ in qs]).astype(jnp.float32), axes=([0], [0])))
    for rank in range(WORLD):
        r = gloo_run[rank]
        # XLA:CPU's dot adds the second term with an FMA, the port rounds
        # it before the sum: the positive sums at most an ulp apart.
        assert np.all(np.abs(r["total"] - jtotal) <= np.spacing(jtotal))
        jres = jax.jit(lambda v: v - jcomp.dequantize_int8(
            *jcomp.quantize_int8(v)))(x[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r["res"], np.asarray(jres))
        scale = float(np.abs(r["exact"]).max())
        assert float(np.abs(r["total"] - r["exact"]).max()) <= (
            scale / 64 + 1e-5)
        # One int8 gather of q and one float32 gather of the scale.
        assert r["gathers"] == {"torch.int8": 1, "torch.float32": 1}
        assert r["tree"] == [True, True]
        # Each rank's residual is its own quantization error, below half
        # a quantum of its scale.
        assert np.abs(r["res"]).max() <= (
            np.abs(x[4 * rank:4 * rank + 4]).max() / 127 * 0.5 + 1e-6)


def test_compressed_step_matches_jax(gloo_run, jax_steps):
    """From the JAX weights, every step's loss and ``grad_norm`` (the
    norm of the reduced gradient divided by the pod count)."""
    want = jax_steps[1]["metrics"]
    for rank in range(WORLD):
        got = gloo_run[rank]["free"]
        np.testing.assert_allclose(np.float64(got), np.float64(want),
                                   rtol=1e-4)


@pytest.mark.parametrize("step", range(STEPS))
def test_compressed_step_from_each_jax_state(jax_steps, gloo_run, jax_fed,
                                             step):
    """From JAX state ``step``: each pod's loss and gradient against the
    JAX ``loss_fn``'s there (rtol 1e-4, atol 1e-6), and the port's step
    against the JAX step fed the same gradients and losses.  The
    residuals are equal bit for bit but where XLA rounds a leaf's scale
    ``max|xr| / 127`` to the other side of its last bit (in this step it
    takes the reciprocal's product, ``max|xr| · (1/127)``, for some
    leaves): then each is within ``q`` ulps of the scale, 127 at most, and
    half an ulp of its own; the rest within 1e-6 relative."""
    fed, out = jax_fed
    ref = out[step]
    jparams, jopt, jres = ref["post"]
    want = {"params": convert.lm_params_from_reference(jparams,
                                                       device="cpu")}
    jstate = convert.opt_state_from_reference(jopt, device="cpu")
    want.update(m=jstate["m"], v=jstate["v"])
    template = jax_steps[1]["states"][0][0]
    before = jax_steps[1]["states"][step][2]
    exact = 0
    for rank in range(WORLD):
        got = gloo_run[rank]["forced"][step]
        jloss, jgrad = ref["own"][rank]
        np.testing.assert_allclose(got["pod_loss"], jloss, rtol=1e-4)
        jgrad = convert.lm_params_from_reference(jgrad, device="cpu")
        assert got["grad"].keys() == jgrad.keys()
        for k, w in jgrad.items():
            np.testing.assert_allclose(got["grad"][k], w.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"gradient {k}")
        leaves = zip(jax.tree.leaves(fed[step]["grad"]),
                     jax.tree.leaves(before), jax.tree.leaves(jres),
                     jax.tree.leaves(_to_reference(got["res"], template)))
        for g, r, jr, pr in leaves:
            xr = g[rank] + r[rank]
            s = (np.float32(np.abs(xr).max()) / np.float32(127)
                 + np.float32(1e-30))
            err = np.abs(pr - jr[rank])
            assert err.max() <= 128 * np.spacing(s), (err.max(), s)
            exact += not err.any()
        for part in ("params", "m", "v"):
            assert got[part].keys() == want[part].keys()
            for k, w in want[part].items():
                _rel_close(got[part][k], w.numpy(), 1e-6,
                           err_msg=f"{part} {k}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=1e-6)
    # Most leaves' residuals are equal bit for bit.
    assert exact >= WORLD * len(jax.tree.leaves(jres)) - 4, exact


def test_compressed_step_at_one_rank_replays_the_plain_step(gloo_run):
    for rank in range(WORLD):
        assert gloo_run[rank]["replay"] == [True] * 3


def test_compressed_step_tracks_the_uncompressed_step(gloo_run):
    cfg = configs.get_reduced(ARCH)
    model, opt = _model_and_opt(cfg)
    step = make_train_step(cfg, OptConfig(**OPT))
    state = {"opt": opt}

    def one(batch):
        _, state["opt"], m = step(model, state["opt"], batch)
        return m["loss"]

    base = _losses(one, STEPS, cfg)
    c0, c1 = gloo_run[0], gloo_run[1]
    assert c0["losses"] == c1["losses"]             # pmean: one loss
    np.testing.assert_array_equal(c0["param0"], c1["param0"])
    comp_l = c0["losses"]
    assert comp_l[-1] < comp_l[0], comp_l
    assert abs(comp_l[-1] - base[-1]) / base[-1] < 0.05, (base, comp_l)
    # Every gradient crossed as int8: one gather of q and one of the
    # scale a leaf of the JAX tree a step.
    n = c0["n_leaves"] * STEPS
    assert c0["step_gathers"] == {"torch.int8": n, "torch.float32": n}
