"""Serving driver (counterpart of ``repro.launch.serve``): batched
prefill, then greedy decode, with per-step latency::

    python -m repro_torch.launch.serve --arch qwen3_1_7b --reduced \\
        --requests 8 --prompt-len 32 --max-new 16 [--device cpu]

The prompts are the JAX driver's (``train.synthetic_batch`` at step 0:
a vision prompt of ``prompt-len`` positions is its patches, then text;
audio takes one token a codebook a step),
the model float32 on one rank as the JAX driver runs at one device,
its weights drawn from a ``torch.Generator`` seeded 0, the caches
``prompt-len + max-new`` long.  Prints the prefill's wall, then decode
p50 / p99 ms a step and tokens a second at p50.  Times are host clocks
around work that ends in a device synchronisation; on the card the
first prefill includes cuBLAS's set-up.  With several ranks (one
process a rank: a ``torch.distributed`` group initialised by the
caller, or ``WORLD_SIZE`` > 1 in the environment) it builds the mesh of
``runtime.elastic.plan_remesh`` over them and sets it, places the
weights and the prompts by ``launch.specs`` and serves in bfloat16, as
the JAX driver does with several devices.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import ShapeConfig, get_config, get_reduced
from ..core.device import resolve_device
from ..distributed import sharding as shrules
from ..models import model as M
from ..runtime.elastic import build_mesh, plan_remesh
from ..serve.lm import make_decode_step, make_prefill_step
from ..train import synthetic_batch
from . import specs
from .mesh import world_size


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    n = world_size(dev)
    mesh = None
    if n > 1:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        plan = plan_remesh(n, model_parallel=min(args.model_parallel, n))
        mesh = build_mesh(plan, dev.type)
        shrules.set_mesh(mesh)
        print(f"mesh: {plan.shape} {plan.axes}")
    dtype = torch.float32 if n == 1 else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev, dtype=dtype)
    cache_len = args.prompt_len + args.max_new
    batch = synthetic_batch(cfg, args.requests, args.prompt_len, 0,
                            device=dev)
    prompts = {k: batch[k] for k in ("tokens", "patch_emb") if k in batch}
    if mesh is not None:
        specs.place_model(model, specs.param_shardings(cfg, model, mesh))
        shape = ShapeConfig("serve", args.prompt_len, args.requests,
                            "prefill")
        prompts = specs.place_tree(prompts, specs.batch_shardings(
            cfg, shape, prompts, mesh))
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(model, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    # [B, 1(, nc)]; the vocabulary gathered whole first on a mesh
    tok = torch.argmax(shrules.unsharded(logits, -1), dim=-1).to(torch.int32)
    pos = torch.full((), args.prompt_len, dtype=torch.int64, device=dev)

    lat = []
    out = [tok]
    for _ in range(args.max_new - 1):
        t1 = time.perf_counter()
        logits, state = decode(model, state, {"tokens": tok}, pos)
        _sync(dev)
        lat.append(time.perf_counter() - t1)
        tok = torch.argmax(shrules.unsharded(logits[:, -1:], -1),
                           dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1

    lat_sorted = sorted(lat[1:]) or [0.0]
    p50 = lat_sorted[len(lat_sorted) // 2]
    p99 = lat_sorted[min(len(lat_sorted) - 1, int(len(lat_sorted) * 0.99))]
    print(f"prefill: {t_prefill * 1e3:.0f} ms for "
          f"{args.requests}x{args.prompt_len} on {dev}")
    print(f"decode:  p50 {p50 * 1e3:.1f} ms/step, p99 {p99 * 1e3:.1f} "
          f"ms/step, throughput {args.requests / max(p50, 1e-9):.0f} tok/s "
          f"steady-state")
    tokens = shrules.to_local_full(torch.cat(out, dim=1))
    shrules.clear()
    return {"prefill_s": t_prefill, "decode_s": lat, "p50_s": p50,
            "p99_s": p99, "tokens": np.asarray(tokens.cpu())}


if __name__ == "__main__":
    main()
