#!/usr/bin/env python3
"""How far a float32 LM's full forward differs from itself, beside how
far decode differs from it, on one NVIDIA GPU, by depth.

Run from the repository root::

    python3 chip_lm_spread.py [--arch falcon_mamba_7b --layers 8,16,32,64]

For each depth, the model (published widths, ``n_layers`` cut to the
depth, float32, weights from a ``torch.Generator`` seeded 0) prefills
8 x 64 synthetic prompts into states of 80 positions and decodes 16
greedy steps; then the full forward over the 80 tokens runs twice, once
over the batch of 8 and once one sequence a call.  Printed, each in
units of 1e-5·max|logits| (the CPU tests' logit tolerance):

* ``decode``: the largest difference between the prefill's last logits
  and every decode step's logits and the batched full forward's at the
  same positions (``chip_smoke.py`` phase 15's comparison);
* ``spread``: the largest difference between the two full forwards, the
  same float32 computation with its matrix products rounded in another
  order.

``chip_smoke.py`` phase 15 holds decode within the larger of the
tolerance and twice ``spread``, since ``spread`` alone passes the
tolerance at falcon-mamba-7b's full depth.  Exits with an error and
prints no result without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

BATCH, PROMPT, NEW = 8, 64, 16


def measure(torch, arch: str, n_layers: int, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import lm
    from repro_torch.train.data import synthetic_batch
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if cfg.n_experts:           # nothing dropped at any token count
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    prompts = synthetic_batch(cfg, BATCH, PROMPT, 0, device=dev)["tokens"]
    decode = lm.make_decode_step(cfg)
    logits, state = lm.make_prefill_step(cfg, PROMPT + NEW)(
        model, {"tokens": prompts})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.full((), PROMPT, dtype=torch.int64, device=dev)
    fed, got = [], [logits[:, 0]]
    for _ in range(NEW):
        fed.append(tok)
        lg, state = decode(model, state, {"tokens": tok}, pos)
        got.append(lg[:, 0])
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        pos = pos + 1
    seq = torch.cat([prompts, torch.cat(fed, dim=1).to(prompts.dtype)], 1)
    with torch.no_grad():
        full = model({"tokens": seq})[0]
        one = torch.cat([model({"tokens": seq[i:i + 1]})[0]
                         for i in range(BATCH)])
    unit = 1e-5 * float(full.abs().max())
    dec = torch.stack(got[:NEW], dim=1).double()
    out = {
        "decode": float((dec - full[:, PROMPT - 1:PROMPT - 1 + NEW].double())
                        .abs().max()) / unit,
        "spread": float((full.double() - one.double()).abs().max()) / unit,
    }
    del model, state, full, one
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="falcon_mamba_7b")
    ap.add_argument("--layers", default="8,16,32,64",
                    help="comma-separated depths")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_lm_spread: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[spread] {card}", flush=True)
    for n in (int(x) for x in args.layers.split(",")):
        t0 = time.perf_counter()
        r = measure(torch, args.arch, n, dev)
        print(f"[spread] {args.arch} at {n} layers: decode {r['decode']:.3f}"
              f", spread {r['spread']:.3f} (times 1e-5·max|logits|); "
              f"decode / spread {r['decode'] / r['spread']:.3f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
