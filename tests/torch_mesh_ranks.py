"""The rank function of ``tests/test_torch_mesh_ranks.py``: one process
of a 4-rank ``gloo`` group, running every multi-rank check of that file
and returning numpy results through a queue.  A module of its own, so
that the spawned ranks import torch and the port but not JAX."""

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

WORLD = 4
TIMEOUT = 300
FAMILIES = ("qwen3_1_7b", "llama4_scout_17b", "falcon_mamba_7b",
            "zamba2_2_7b", "phi3_vision_4_2b", "musicgen_large")
BATCH, SEQ = 4, 24


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(x):
    from repro_torch.distributed.sharding import to_local_full
    return to_local_full(x).detach().float().cpu().numpy()


def _families(mesh, rank):
    """Each family's reduced forward: on one process (rank 0, plain
    tensors, the mesh set so that MoE shards as on the mesh) and on the
    mesh (DTensor parameters placed by the specs, a DTensor batch)."""
    from repro_torch.configs import SHAPES, get_reduced
    from repro_torch.distributed import sharding
    from repro_torch.launch import specs
    from repro_torch.models import model as M
    from repro_torch.train import synthetic_batch
    out = {}
    for arch in FAMILIES:
        cfg = get_reduced(arch)
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        batch = synthetic_batch(cfg, BATCH, SEQ, 0, device="cpu")
        prompts = {k: batch[k] for k in ("tokens", "patch_emb") if k in batch}
        sharding.set_mesh(mesh)
        with torch.no_grad():
            if rank == 0:
                out[f"{arch}/one"] = _np(model(prompts)[0])
            specs.place_model(model, specs.param_shardings(cfg, model, mesh))
            placed = specs.place_tree(prompts, specs.batch_shardings(
                cfg, SHAPES["train_4k"], prompts, mesh))
            logits = model(placed)[0]
        assert isinstance(logits, DTensor)
        out[f"{arch}/mesh"] = _np(logits)
        sharding.clear()
    return out


def _dense(mesh, rank):
    """The dense family's train step (2 microbatches) and prefill plus
    decode, on one process and on the mesh."""
    from repro_torch.configs import SHAPES, get_reduced
    from repro_torch.distributed import sharding
    from repro_torch.launch import specs
    from repro_torch.models import model as M
    from repro_torch.serve.lm import greedy_decode, make_prefill_step
    from repro_torch.train import (OptConfig, init_opt_state,
                                   make_train_step, synthetic_batch)
    cfg = get_reduced("qwen3_1_7b")
    ocfg = OptConfig(lr=1e-3, warmup_steps=20)
    batch = synthetic_batch(cfg, BATCH, SEQ, 0, device="cpu")
    out = {}
    for where in ("one", "mesh"):
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        opt = init_opt_state(M.params_of(model), ocfg)
        b = batch
        sharding.set_mesh(mesh)
        if where == "mesh":
            specs.place_model(model, specs.param_shardings(cfg, model, mesh))
            opt = specs.place_tree(opt, specs.opt_shardings(cfg, opt, mesh))
            b = specs.place_tree(batch, specs.batch_shardings(
                cfg, SHAPES["train_4k"], batch, mesh))
        if where == "one" and rank != 0:
            sharding.clear()
            continue
        _, opt, m = make_train_step(cfg, ocfg, 2)(model, opt, b)
        out[f"train/{where}/loss"] = _np(m["loss"])
        out[f"train/{where}/grad_norm"] = _np(m["grad_norm"])
        for n, p in M.params_of(model).items():
            out[f"train/{where}/p/{n}"] = _np(p)
        prompts = {"tokens": b["tokens"]}
        logits, state = make_prefill_step(cfg, cache_len=SEQ + 6)(model,
                                                                  prompts)
        first = torch.argmax(sharding.unsharded(logits, -1), -1)
        toks, _ = greedy_decode(cfg, model, state, first, SEQ, 6)
        out[f"serve/{where}/prefill"] = _np(logits)
        out[f"serve/{where}/tokens"] = _np(toks)
        sharding.clear()
    return out


def _moe(ref, rank):
    """The MoE layer at ``ns`` = 2 and 4 (meshes (2, 2) and (4, 1)) on
    one process (plain tensors, the mesh set) and on the mesh, from the
    file's weights; the kept assignments; the ``T % ns`` fallback."""
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    d, ff, e = ref["moe/wi"].shape[1], ref["moe/wi"].shape[2], \
        ref["moe/router"].shape[1]
    out = {}
    for ns in (2, 4):
        mesh = init_device_mesh("cpu", (ns, WORLD // ns),
                                mesh_dim_names=("data", "model"))
        for case in ("x", "x_small"):
            for cf in ("cf", "cf_low"):
                p = moe.MoE(d, ff, e, device="cpu")
                p.load_state_dict({k: torch.from_numpy(ref[f"moe/{k}"])
                                   for k in ("router", "wi", "wg", "wo")})
                x = torch.from_numpy(ref[f"moe/{case}"])
                kw = dict(top_k=int(ref["moe/top_k"]),
                          capacity_factor=float(ref[f"moe/{cf}"]))
                key = f"moe/{ns}/{case}/{cf}"
                sharding.set_mesh(mesh)
                with torch.no_grad():
                    xt = x.reshape(-1, d)
                    out[f"{key}/ns"] = np.int64(moe.n_data_shards(
                        xt.shape[0]))
                    if rank == 0:
                        y, aux = moe.moe_layer(p, x, **kw)
                        out[f"{key}/one/y"], out[f"{key}/one/aux"] = \
                            _np(y), _np(aux)
                        r = moe.route(p.router, xt, kw["top_k"],
                                      kw["capacity_factor"],
                                      moe.n_data_shards(xt.shape[0]))
                        flat_e = r.eidx.reshape(-1)
                        kept = r.order[r.keep]
                        out[f"{key}/kept"] = np.stack(
                            [_np(torch.div(kept, kw["top_k"],
                                           rounding_mode="floor")),
                             _np(flat_e[kept])], 1).astype(np.int64)
                        out[f"{key}/dropped"] = _np(moe.dropped(p, x, **kw))
                    from repro_torch.launch import specs
                    for n, t in (("wi", p.wi), ("wg", p.wg), ("wo", p.wo)):
                        setattr(p, n, torch.nn.Parameter(specs.place(
                            t.detach(), sharding.NamedSharding(
                                mesh, ("model", None, None)))))
                    p.router = torch.nn.Parameter(specs.place(
                        p.router.detach(), sharding.NamedSharding(mesh, ())))
                    # the batch over the data axis where it divides
                    bspec = "data" if x.shape[0] % ns == 0 else None
                    xd = specs.place(x, sharding.NamedSharding(
                        mesh, (bspec, None, None)))
                    y, aux = moe.moe_layer(p, xd, **kw)
                    out[f"{key}/mesh/y"], out[f"{key}/mesh/aux"] = \
                        _np(y), _np(aux)
                sharding.clear()
    return out


def _pipeline(ref):
    """The JAX pipeline test's problem on a (2 pod, 2 data) mesh:
    outputs and the full gradient."""
    from repro_torch.distributed.pipeline import pipeline_map
    from repro_torch.launch import specs
    from repro_torch.distributed.sharding import NamedSharding
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))

    def stage_fn(wstack, x):
        for w in wstack:
            x = torch.tanh(x @ w)
        return x

    ws = torch.from_numpy(ref["pipe/ws"])
    mbs = torch.from_numpy(ref["pipe/mbs"])
    wd = specs.place(ws, NamedSharding(mesh, ("pod", None, None)))
    wd.requires_grad_(True)
    run = pipeline_map(stage_fn, mesh, n_stages=2, axis="pod")
    y = run(wd, mbs)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), [wd])
    return {"pipe/out": _np(y), "pipe/grad": _np(g),
            "pipe/plain_out": _np(run(ws, mbs))}


def _elastic(mesh, rank, tmp):
    """Save on the (2, 2) mesh of 4 ranks; restore onto the mesh of
    ``plan_remesh(2, model_parallel=2)`` on 2 of them; the same for a
    ``MedoidService`` snapshot (written by rank 0)."""
    from repro_torch.core import datasets
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch import specs
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.elastic import build_mesh, plan_remesh
    from repro_torch.serve import MedoidService
    out = {}
    w = specs.place(torch.arange(32.0).reshape(8, 4),
                    NamedSharding(mesh, ("data", "model")))
    state = {"w": w, "step": np.int32(7)}
    ckpt.save(os.path.join(tmp, "elastic"), 7, state,
              extra={"note": "pre-failure"})
    svc_dir = os.path.join(tmp, "service")
    q = datasets.mnist_like(32, seed=2, d=16)
    if rank == 0:
        svc = MedoidService(4, "l2", reservoir_size=64, drift_window=50,
                            request_chunk=128, seed=0, device="cpu")
        svc.fit(datasets.mnist_like(300, seed=0, d=16))
        svc.ingest(datasets.mnist_like(80, seed=1, d=16) + 0.2)
        svc.snapshot(svc_dir)
        out["service/want"] = np.asarray(svc.predict(q))
        out["service/want_stats"] = repr(svc.stats())
    dist.barrier()
    plan = plan_remesh(2, model_parallel=2)
    out["elastic/plan"] = np.asarray(plan.shape)
    small = build_mesh(plan, "cpu")
    if rank < 2:
        sh = NamedSharding(small, ("data", "model"))
        restored, meta = ckpt.restore(os.path.join(tmp, "elastic"), state,
                                      shardings={"w": sh, "step": None})
        out["elastic/placements"] = repr(tuple(restored["w"].placements))
        out["elastic/mesh"] = repr(dict(zip(small.mesh_dim_names,
                                            small.shape)))
        out["elastic/w"] = _np(restored["w"])
        out["elastic/step"] = np.int64(meta["step"])
        out["elastic/step_leaf"] = np.asarray(restored["step"])
        leaf = {"medoid_points": NamedSharding(small, ("model", None))}
        svc2 = MedoidService.restore(svc_dir, device="cpu", shardings=leaf)
        out["service/got"] = np.asarray(svc2.predict(q))
        out["service/got_stats"] = repr(svc2.stats())
    dist.barrier()
    return out


def _drivers(rank, tmp):
    """The serving and train drivers on the 4 ranks (their own (2, 2)
    mesh from ``plan_remesh``, bfloat16): greedy tokens; 2 train steps
    checkpointed every 2, then one more resumed from the last."""
    import signal
    from repro_torch.launch import serve, train
    out = {}
    got = serve.main(["--arch", "qwen3_1_7b", "--reduced", "--device",
                      "cpu", "--requests", "4", "--prompt-len", "8",
                      "--max-new", "2", "--model-parallel", "2"])
    out["drivers/serve"] = got["tokens"]
    handler = signal.getsignal(signal.SIGTERM)
    try:
        argv = ["--arch", "qwen3_1_7b", "--reduced", "--device", "cpu",
                "--batch", "4", "--seq", "16", "--save-every", "2",
                "--model-parallel", "2", "--ckpt-dir",
                os.path.join(tmp, "train")]
        first = train.main(argv + ["--steps", "2"])
        resumed = train.main(argv + ["--steps", "3"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    out["drivers/mesh"] = repr(first["mesh"])
    out["drivers/losses"] = np.asarray(first["losses"] + resumed["losses"])
    out["drivers/starts"] = np.asarray([first["start"], resumed["start"]])
    return out


def _sharded_fit(mesh, rank):
    """The sharded fit over the (2, 2) mesh's data axis (``mesh=``):
    through ``DistributedBanditPAM``, the ``banditpam_dist`` solver and
    ``MedoidCurator``; and the same fit over the explicit group of this
    rank's data shards (ranks ``model``, ``model + 2``)."""
    from repro_torch.api import KMedoids
    from repro_torch.core.datasets import mnist_like
    from repro_torch.core.distributed import (DistributedBanditPAM,
                                              MedoidCurator)
    x = mnist_like(240, seed=3, d=16)
    groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    fits = {"mesh": DistributedBanditPAM(3, mesh=mesh, device="cpu"),
            "group": DistributedBanditPAM(3, groups[rank % 2],
                                          device="cpu")}
    out = {"fit/n_shards": np.int64(fits["mesh"].n_shards)}
    for name, est in fits.items():
        rep = est.fit(x)
        out[f"fit/{name}/medoids"] = np.asarray(rep.medoids)
        out[f"fit/{name}/loss"] = np.float64(rep.loss)
        out[f"fit/{name}/evals"] = repr(rep.evals_by_phase)
    est = KMedoids(3, solver="banditpam_dist", device="cpu", mesh=mesh)
    out["fit/solver/medoids"] = np.asarray(est.fit(x).medoids_)
    med, assign = MedoidCurator(3, mesh=mesh, metric="l2",
                                device="cpu").curate(x)
    out["fit/curator/medoids"] = np.asarray(med)
    out["fit/curator/assign"] = np.asarray(assign)
    return out


def rank_main(rank, init, in_path, tmp, queue):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        ref = dict(np.load(in_path))             # the checks' inputs
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {}
        out.update(_families(mesh, rank))
        out.update(_dense(mesh, rank))
        out.update(_moe(ref, rank))
        out.update(_pipeline(ref))
        out.update(_elastic(mesh, rank, tmp))
        out.update(_drivers(rank, tmp))
        out.update(_sharded_fit(mesh, rank))
        queue.put((rank, out))
    except BaseException as e:
        queue.put((rank, e))
        raise
    finally:
        dist.destroy_process_group()
