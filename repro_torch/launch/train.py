"""Training driver (counterpart of ``repro.launch.train``): mesh
construction, sharded state, the data pipeline and the fault-tolerant
loop with checkpoint / resume::

    python -m repro_torch.launch.train --arch qwen3_1_7b --reduced \\
        --steps 100 --batch 8 --seq 64 --ckpt-dir build/train_ckpt \\
        [--device cpu]

One process a rank.  With several ranks (a ``torch.distributed`` group
initialised by the caller, or ``WORLD_SIZE`` > 1 in the environment, as
``torchrun`` sets it: ``nccl`` on the card, ``gloo`` on the CPU) it
builds the mesh of ``runtime.elastic.plan_remesh`` over the group, sets
it (``distributed.sharding.set_mesh``), places the parameters, the
optimizer state and every batch by ``launch.specs`` and trains in
bfloat16, as the JAX driver does; on one rank there is no mesh and the
state is float32.  Either way it runs ``train.make_train_step``, the
step-indexed ``DataPipeline`` and ``FaultTolerantLoop``, resuming from
the latest checkpoint in ``--ckpt-dir``, and logs every 10 steps.

``main(argv)`` returns what the run measured: each step's loss (floats,
in order, from the resumed step on), each step's wall (host clock
around a step that ends in a device synchronisation), their p50, tokens
a second at the p50 and the device's peak memory (``None`` on the
CPU).  The card is the default device; without one ``main`` raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ShapeConfig, get_config, get_reduced
from ..core.device import resolve_device
from ..distributed import sharding as shrules
from ..models import model as M
from ..runtime.elastic import build_mesh, plan_remesh
from ..runtime.fault import FaultTolerantLoop
from ..train import DataPipeline, OptConfig, init_opt_state, make_train_step
from . import specs
from .mesh import world_size


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    n = world_size(dev)
    lead = n == 1 or dist.get_rank() == 0
    mesh = None
    if n > 1:
        plan = plan_remesh(n, model_parallel=min(args.model_parallel, n))
        mesh = build_mesh(plan, dev.type)
        shrules.set_mesh(mesh)
        if lead:
            print(f"mesh: {plan.shape} {plan.axes} "
                  f"(dropped {plan.dropped_chips})")

    dtype = torch.float32 if n == 1 else torch.bfloat16
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=dtype)
    ocfg = OptConfig(lr=1e-3, warmup_steps=20, moment_dtype=cfg.moment_dtype)
    opt = init_opt_state(M.params_of(model), ocfg)
    shape = ShapeConfig("train", args.seq, args.batch, "train",
                        args.microbatches)
    shardings = None
    if mesh is not None:
        p_sh = specs.param_shardings(cfg, model, mesh)
        specs.place_model(model, p_sh)
        o_sh = specs.opt_shardings(cfg, opt, mesh)
        opt = specs.place_tree(opt, o_sh)
        shardings = {"params": p_sh, "opt": o_sh}
    step_fn = make_train_step(cfg, ocfg, args.microbatches)
    pipe = DataPipeline(cfg, args.batch, args.seq, device=dev)

    loop = FaultTolerantLoop(args.ckpt_dir, save_every=args.save_every)
    state = {"params": M.params_of(model), "opt": opt}
    state, start = loop.restore_or(state, shardings)
    if start and lead:
        print(f"resumed at step {start}")

    losses, walls = {}, []
    t0 = time.time()

    def one_step(st, i):
        M.load_params(model, st["params"])
        pipe.step = i
        batch = next(pipe)
        if mesh is not None:
            batch = specs.place_tree(batch, specs.batch_shardings(
                cfg, shape, batch, mesh))
        _sync(dev)
        t1 = time.perf_counter()
        _, o, m = step_fn(model, st["opt"], batch)
        _sync(dev)
        walls.append(time.perf_counter() - t1)
        losses[i] = m["loss"]
        if i % 10 == 0:
            loss = float(shrules.to_local_full(m["loss"]))
            lr = float(shrules.to_local_full(m["lr"]))
            if lead:
                print(f"step {i:5d} loss {loss:.4f} lr {lr:.2e} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        return {"params": M.params_of(model), "opt": o}, m

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop.run(state, one_step, n_steps=args.steps, start_step=start)
    shrules.clear()
    losses = [float(shrules.to_local_full(losses[i])) for i in sorted(losses)]
    p50 = float(np.median(walls)) if walls else float("nan")
    if lead:
        print("training complete")
    return {"start": start, "losses": losses, "step_s": walls,
            "p50_s": p50, "tokens_per_s": args.batch * args.seq / p50,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "mesh": None if mesh is None else dict(zip(
                mesh.mesh_dim_names, mesh.shape)),
            "device": str(dev)}


if __name__ == "__main__":
    main()
