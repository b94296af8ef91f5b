"""LM training with medoid-curated data and a fault-tolerant loop (the
counterpart of ``examples/train_lm_curated.py``): checkpoint every N
steps, auto-resume.

Curation: every R steps the driver embeds a candidate pool of sequences
(the mean of the LM's logits over positions, one point of ``vocab``
features a sequence), clusters it with BanditPAM (cosine, the leader
baseline: ``core.distributed.MedoidCurator``, which on the card runs the
hand-written kernels) and reports inverse-cluster-size weights.  As in
the JAX example, the weights are computed and reported and the training
batch stays ``synthetic_batch(cfg, batch, seq, step)``.

Presets: ``--preset cpu-small`` (1.3M parameters) | ``--preset 100m``
(125M);
``--full`` runs ``get_config("qwen3_1_7b")`` unmodified (2.03B
parameters; float32 weights, gradients and AdamW moments take about
33 GB).

    python -m repro_torch.train.curated --preset cpu-small --steps 200 \\
        --ckpt-dir build/lm_ckpt

The card is the default device; without one ``main`` raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import ArchConfig, get_config
from ..core.device import DeviceLike, resolve_device
from ..core.distributed import MedoidCurator
from ..models import model as M
from ..runtime.fault import FaultTolerantLoop
from .data import synthetic_batch
from .optimizer import OptConfig, init_opt_state
from .train_step import make_train_step

PRESETS = {
    "cpu-small": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=384, vocab=2048),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=32000),
}
# The example's optimizer.
OPT = OptConfig(lr=3e-3, warmup_steps=20)


def preset_config(preset: str) -> ArchConfig:
    return dataclasses.replace(get_config("qwen3_1_7b"), **PRESETS[preset])


def embed_pool(cfg: ArchConfig, model: M.Decoder, step: int, pool: int = 64,
               seq: int = 32, device: DeviceLike = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The candidate pool of ``step`` (``synthetic_batch`` at step
    ``10,000 + step``) and its embeddings, [pool, vocab] float32."""
    dev = resolve_device(device)
    batch = synthetic_batch(cfg, pool, seq, 10_000 + step, device=dev)
    with torch.no_grad():
        logits, _ = model({"tokens": batch["tokens"]})
    return batch, torch.mean(logits, dim=1).to(torch.float32)


def cluster_weights(emb: torch.Tensor, k: int, seed: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster ``emb`` ([pool, d], on its device) with
    ``MedoidCurator(k, metric="cosine", seed=seed)``; returns the
    medoids, the assignment and the balanced-coverage weights (inverse
    cluster frequency, summing to 1)."""
    medoids, assign = MedoidCurator(k, metric="cosine", seed=seed,
                                    device=emb.device).curate(emb)
    sizes = np.bincount(assign, minlength=k).astype(np.float32)
    w = 1.0 / sizes[assign]
    return medoids, assign, w / w.sum()


def curate_weights(cfg: ArchConfig, model: M.Decoder, step: int,
                   pool: int = 64, k: int = 8, seq: int = 32,
                   device: DeviceLike = None
                   ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Cluster a candidate pool of sequences; upweight medoid-near docs.
    Returns the pool's batch and its [pool] float32 weights."""
    batch, emb = embed_pool(cfg, model, step, pool, seq, device)
    return batch, cluster_weights(emb, k, step)[2]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.train.curated",
        description="LM training with medoid-curated data")
    ap.add_argument("--preset", default="cpu-small", choices=PRESETS)
    ap.add_argument("--full", action="store_true",
                    help="qwen3-1.7B unmodified instead of a preset")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--curate-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config("qwen3_1_7b") if args.full
           else preset_config(args.preset))
    n_params = cfg.param_count()["total"]
    print(f"arch=qwen3-family preset={'full' if args.full else args.preset} "
          f"params~{n_params / 1e6:.1f}M device={dev}")

    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    opt = init_opt_state(M.params_of(model), OPT)
    step_fn = make_train_step(cfg, OPT, microbatches=1)

    loop = FaultTolerantLoop(args.ckpt_dir, save_every=50)
    state = {"params": M.params_of(model), "opt": opt}
    state, start = loop.restore_or(state)
    if start:
        print(f"resumed from checkpoint at step {start}")

    t0 = time.time()
    losses = []

    def one_step(st, i):
        M.load_params(model, st["params"])
        if i % args.curate_every == 0:
            _, w = curate_weights(cfg, model, i, device=dev)
            print(f"  [curate] step {i}: medoid-balanced pool "
                  f"(max_w/min_w={w.max() / w.min():.1f})")
        batch = synthetic_batch(cfg, args.batch, args.seq, i, device=dev)
        _, o, m = step_fn(model, st["opt"], batch)
        losses.append(float(m["loss"]))
        if i % 20 == 0:
            print(f"  step {i:4d} loss {losses[-1]:.3f} "
                  f"gnorm {float(m['grad_norm']):.2f}")
        return {"params": M.params_of(model), "opt": o}, m

    loop.run(state, one_step, n_steps=args.steps, start_step=start)
    dt = time.time() - t0
    if not losses:
        print(f"done: nothing to run past step {start}")
        return
    print(f"done: {len(losses)} steps in {dt:.0f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
