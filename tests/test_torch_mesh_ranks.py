"""The port's mesh layer on several ranks: one spawned group of 4 ``gloo``
ranks on the CPU (a free ``tcp://127.0.0.1`` port, a timeout on the
group and on the run) runs every check of this file once
(``tests/torch_mesh_ranks.py``), against the JAX package run in a
subprocess with 4 simulated host devices:

* every family's reduced forward (dense, MoE, Mamba-1, hybrid, vision,
  audio) with DTensor parameters placed by ``launch.specs`` and a
  DTensor batch on a (2, 2) ``("data", "model")`` mesh, held against
  the port on one process within 1e-5·max|logits| (the sums over a
  sharded contraction run in another order);
* the dense family's train step at 2 microbatches there: the loss and
  ``grad_norm`` within rtol 1e-4 and the updated parameters within the
  LM tests' rtol 1e-4 / atol 1e-6; its prefill within 1e-5·max|logits|
  and 6 greedy decode steps' tokens equal;
* the MoE layer at ``ns`` = 2 and 4 (data extents 2 and 4) against the
  JAX ``moe_layer`` under a simulated mesh of that data extent, at the
  config's capacity factor and at 0.5 (drops): the kept (token, expert)
  assignments equal, y within rtol 1e-5 / atol 1e-5·max, the aux loss
  within rtol 1e-6, on one process and on the mesh; 6 tokens on the
  extent-4 mesh fall back to one shard, as in JAX;
* ``distributed.pipeline.pipeline_map`` over the ``pod`` axis of a
  (2, 2) ``("pod", "data")`` mesh on ``tests/test_pipeline.py``'s
  problem: outputs within 1e-5 of the JAX ``pipeline_map``, the full
  gradient within rtol 1e-5 of ``jax.grad`` (atol 1e-5·max|g|);
* the elastic restore: a checkpoint saved from a DTensor on the (2, 2)
  mesh restores onto ``plan_remesh(2, model_parallel=2)``'s mesh on 2
  ranks, placed as asked, its values bit for bit and its step kept; a
  ``MedoidService`` snapshot restores there with ``shardings=`` and
  predicts and reports as the service it was taken from;
* the sharded fit with ``mesh=`` (``DistributedBanditPAM``, the
  ``banditpam_dist`` solver, ``MedoidCurator``) shards over the mesh's
  data axis, 2 ranks, the ranks along ``model`` holding the same shard:
  every rank's report equals the fit over the explicit group of its
  data shards;
* the drivers on the 4 ranks: ``launch.serve`` and ``launch.train``
  build the (2, 2) mesh of ``plan_remesh(4, model_parallel=2)`` and run
  in bfloat16; every rank gets the same greedy tokens and the same
  finite losses, and the train driver resumes from its last checkpoint.
"""

import multiprocessing
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch import configs
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed import sharding
    from repro.distributed.pipeline import pipeline_map
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe as jmoe

    inp = dict(np.load(sys.argv[1]))
    out = {}
    jp = {k: inp[f"moe/{k}"] for k in ("router", "wi", "wg", "wo")}
    k = int(inp["moe/top_k"])
    for ns in (2, 4):
        mesh = make_debug_mesh((ns, 4 // ns), ("data", "model"))
        sharding.set_mesh(mesh)
        for case in ("x", "x_small"):
            for cf in ("cf", "cf_low"):
                x = jnp.asarray(inp[f"moe/{case}"])
                f = jax.jit(lambda p, x: jmoe.moe_layer(
                    p, x, top_k=k, capacity_factor=float(inp[f"moe/{cf}"])))
                y, aux = f(jax.tree.map(jnp.asarray, jp), x)
                key = f"moe/{ns}/{case}/{cf}"
                out[f"{key}/y"], out[f"{key}/aux"] = np.asarray(y), \\
                    np.asarray(aux)
                # the kept assignments: the layer's dispatch lines
                # restated per shard (it returns no plan)
                xt = x.reshape(-1, x.shape[-1])
                t, e = xt.shape[0], jp["router"].shape[1]
                s = jmoe._n_data_shards()
                s = 1 if t % s else s
                c = jmoe.capacity(t // s, k, e, float(inp[f"moe/{cf}"]))
                probs = jax.nn.softmax(xt @ jnp.asarray(jp["router"]), -1)
                _, eidx = jax.lax.top_k(probs, k)
                kept = []
                for sh in range(s):
                    flat_e = eidx[sh * (t // s):(sh + 1) * (t // s)].reshape(-1)
                    order = jnp.argsort(flat_e, stable=True)
                    sorted_e = flat_e[order]
                    seg = jnp.searchsorted(sorted_e, jnp.arange(e))
                    keep = (jnp.arange(flat_e.shape[0]) - seg[sorted_e]) < c
                    kept += [(sh * (t // s) + int(o) // k, int(se))
                             for o, se, kp in zip(np.asarray(order),
                                                  np.asarray(sorted_e),
                                                  np.asarray(keep)) if kp]
                out[f"{key}/kept"] = np.asarray(sorted(kept), np.int64)
                out[f"{key}/ns"] = np.int64(s)
                out[f"{key}/n_assign"] = np.int64(t * k)
        sharding.clear()

    # tests/test_pipeline.py's problem on a (2 pod, 2 data) mesh
    mesh = make_debug_mesh((2, 2), ("pod", "data"))
    ws, mbs = jnp.asarray(inp["pipe/ws"]), jnp.asarray(inp["pipe/mbs"])

    def stage_fn(wstack, x):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, wstack)
        return h

    run = pipeline_map(stage_fn, mesh, n_stages=2, axis="pod",
                       params_spec=P("pod"), x_spec=P(None))
    out["pipe/out"] = np.asarray(run(ws, mbs))
    out["pipe/grad"] = np.asarray(
        jax.grad(lambda w: jnp.sum(run(w, mbs) ** 2))(ws))
    np.savez(sys.argv[2], **out)
""")


def _inputs():
    """The checks' inputs, seeded numpy: an MoE layer at the reduced
    llama4's widths (N(0, 1/fan_in) weights), its token batches, and
    ``tests/test_pipeline.py``'s problem (D 16, 4 layers, 3
    microbatches of 8)."""
    cfg = configs.get_reduced("llama4_scout_17b")
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(7)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {"moe/router": normal((d, e), d ** -0.5),
            "moe/wi": normal((e, d, ff), d ** -0.5),
            "moe/wg": normal((e, d, ff), d ** -0.5),
            "moe/wo": normal((e, ff, d), ff ** -0.5),
            "moe/x": normal((4, 64, d), 1.0),
            "moe/x_small": normal((2, 3, d), 1.0),
            "moe/top_k": np.int64(cfg.top_k),
            "moe/cf": np.float64(cfg.capacity_factor),
            "moe/cf_low": np.float64(0.5),
            "pipe/ws": normal((4, 16, 16), 0.3),
            "pipe/mbs": normal((3, 8, 16), 1.0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(every rank's results, the JAX results)``: one spawned group
    for the file, the JAX subprocess running beside it on the same
    inputs."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    in_path, jax_path = str(tmp / "in.npz"), str(tmp / "jax.npz")
    np.savez(in_path, **_inputs())
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX, in_path,
                                 jax_path], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    init = f"tcp://127.0.0.1:{ranks.free_port()}"
    procs = torch.multiprocessing.start_processes(
        ranks.rank_main, args=(init, in_path, str(tmp), queue),
        nprocs=ranks.WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + ranks.TIMEOUT
    out = {}
    try:
        while True:
            while not queue.empty():
                rank, value = queue.get()
                out[rank] = value
            if procs.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{ranks.WORLD} ranks ran past "
                                   f"{ranks.TIMEOUT} s")
        while not queue.empty():
            rank, value = queue.get()
            out[rank] = value
        _, err = jax_proc.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    assert sorted(out) == list(range(ranks.WORLD))
    for r, v in out.items():
        assert not isinstance(v, BaseException), (r, v)
    return out, dict(np.load(jax_path))


@pytest.fixture(scope="module")
def gloo_run(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


def _within(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("arch", ranks.FAMILIES)
def test_family_forward_on_mesh(gloo_run, arch):
    want = gloo_run[0][f"{arch}/one"]
    assert np.isfinite(want).all()
    for r in range(ranks.WORLD):
        _within(gloo_run[r][f"{arch}/mesh"], want, 1e-5)


def test_dense_train_step_on_mesh(gloo_run):
    one = gloo_run[0]
    for r in range(ranks.WORLD):
        got = gloo_run[r]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"train/mesh/{k}"],
                                       one[f"train/one/{k}"], rtol=1e-4)
        names = [k for k in one if k.startswith("train/one/p/")]
        assert names
        for k in names:
            np.testing.assert_allclose(
                got[k.replace("/one/", "/mesh/")], one[k], rtol=1e-4,
                atol=1e-6, err_msg=k)


def test_dense_prefill_and_decode_on_mesh(gloo_run):
    one = gloo_run[0]
    for r in range(ranks.WORLD):
        _within(gloo_run[r]["serve/mesh/prefill"], one["serve/one/prefill"],
                1e-5)
        np.testing.assert_array_equal(gloo_run[r]["serve/mesh/tokens"],
                                      one["serve/one/tokens"])


@pytest.mark.parametrize("cf", ["cf", "cf_low"])
@pytest.mark.parametrize("case", ["x", "x_small"])
@pytest.mark.parametrize("ns", [2, 4])
def test_moe_shards_match_jax(gloo_run, jax_ref, ns, case, cf):
    key = f"moe/{ns}/{case}/{cf}"
    want_ns = int(jax_ref[f"{key}/ns"])
    assert want_ns == (1 if case == "x_small" and ns == 4 else ns)
    got = gloo_run[0]
    assert int(got[f"{key}/ns"]) == want_ns
    assert sorted(map(tuple, got[f"{key}/kept"].tolist())) == \
        list(map(tuple, jax_ref[f"{key}/kept"].tolist()))
    drops = int(jax_ref[f"{key}/n_assign"]) - len(jax_ref[f"{key}/kept"])
    assert int(got[f"{key}/dropped"]) == drops
    if cf == "cf_low" and case == "x":
        assert drops > 0
    wy, waux = jax_ref[f"{key}/y"], jax_ref[f"{key}/aux"]
    for r in range(ranks.WORLD):
        for where in (("one", "mesh") if r == 0 else ("mesh",)):
            y = gloo_run[r][f"{key}/{where}/y"]
            np.testing.assert_allclose(y, wy, rtol=1e-5,
                                       atol=1e-5 * np.abs(wy).max())
            np.testing.assert_allclose(gloo_run[r][f"{key}/{where}/aux"],
                                       waux, rtol=1e-6)


def test_pipeline_matches_jax(gloo_run, jax_ref):
    g = jax_ref["pipe/grad"]
    for r in range(ranks.WORLD):
        got = gloo_run[r]
        np.testing.assert_allclose(got["pipe/out"], jax_ref["pipe/out"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["pipe/plain_out"], got["pipe/out"],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(got["pipe/grad"], g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


def test_elastic_restore_onto_smaller_mesh(gloo_run):
    want = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    for r in range(2):
        got = gloo_run[r]
        assert list(got["elastic/plan"]) == [1, 2]
        assert got["elastic/mesh"] == repr({"data": 1, "model": 2})
        assert got["elastic/placements"] == "(Shard(dim=0), Shard(dim=1))"
        assert got["elastic/w"].tobytes() == want.tobytes()
        assert int(got["elastic/step"]) == 7
        assert got["elastic/step_leaf"].dtype == np.int32
        assert int(got["elastic/step_leaf"]) == 7
    assert all("elastic/w" not in gloo_run[r] for r in (2, 3))


def test_service_restore_onto_mesh(gloo_run):
    want = gloo_run[0]["service/want"]
    for r in range(2):
        np.testing.assert_array_equal(gloo_run[r]["service/got"], want)
        assert gloo_run[r]["service/got_stats"] == \
            gloo_run[0]["service/want_stats"]


def test_drivers_on_a_mesh(gloo_run):
    want = gloo_run[0]
    assert want["drivers/serve"].shape == (4, 2)
    assert want["drivers/mesh"] == repr({"data": 2, "model": 2})
    assert list(want["drivers/starts"]) == [0, 2]
    assert len(want["drivers/losses"]) == 3
    assert np.isfinite(want["drivers/losses"]).all()
    for r in range(1, ranks.WORLD):
        np.testing.assert_array_equal(gloo_run[r]["drivers/serve"],
                                      want["drivers/serve"])
        np.testing.assert_array_equal(gloo_run[r]["drivers/losses"],
                                      want["drivers/losses"])


def test_sharded_fit_takes_a_mesh(gloo_run):
    want = gloo_run[0]
    assert int(want["fit/n_shards"]) == 2
    for r in range(ranks.WORLD):
        got = gloo_run[r]
        for k in ("medoids", "loss", "evals"):
            assert np.array_equal(got[f"fit/mesh/{k}"],
                                  want[f"fit/group/{k}"]), (r, k)
        np.testing.assert_array_equal(got["fit/solver/medoids"],
                                      want["fit/group/medoids"])
        np.testing.assert_array_equal(got["fit/curator/medoids"],
                                      want["fit/curator/medoids"])
        np.testing.assert_array_equal(got["fit/curator/assign"],
                                      want["fit/curator/assign"])
