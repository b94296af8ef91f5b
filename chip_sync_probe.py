#!/usr/bin/env python3
"""List every sync the port's device-resident drivers make outside the
sanctioned points, on one NVIDIA GPU.

Run from the root of a checkout of the repository::

    python3 chip_sync_probe.py [--rows 3000]

``analysis.FitGuard`` runs a fit under ``torch.cuda.set_sync_debug_mode
("error")`` and stops at the first sync.  This script runs each driver
once to warm up, then again under the ``"warn"`` mode with every warning
kept, and prints each distinct call site that synchronised (the port's
frames of its stack) with its count, for: the default fit, replacement
sampling with the leader, the PIC ring, a warm start, ``fit_batch`` in
both reuse modes, and the sharded fit at world size 1 on nccl in both
reuse modes (``mnist_like``, d = 784, k = 10, l2, ``backend="cuda"``, the
data given as numpy).  The sanctioned points (``engine.host_read``,
``engine.host_stage``, the phase walls) lift the mode and do not show.
Prints the card's name and power limit; exits 1 when a driver made a
sync, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
# torch's own notice that the mode is a prototype, raised when it is set.
PROTOTYPE = "prototype feature"


def probe(torch, name, fn):
    """Run ``fn`` once, then under the warn mode; print and return its
    sync sites."""
    fn()
    torch.cuda.synchronize()
    sites = {}

    def keep(message, category, filename, lineno, file=None, line=None):
        if PROTOTYPE in str(message):
            return
        frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                  f"{(f.line or '').strip()}"
                  for f in traceback.extract_stack()
                  if "repro_torch" in f.filename]
        key = " <- ".join(reversed(frames[-3:]))
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"[sync] {name}: {len(sites)} sites, {sum(sites.values())} syncs",
          flush=True)
    for key, count in sites.items():
        print(f"[sync]   x{count} {key}", flush=True)
    return sites


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=3000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_sync_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from repro_torch.core import BanditPAM, datasets
    from repro_torch.core import distributed as tdist
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    X = datasets.mnist_like(args.rows, seed=1)
    lanes = [X[:2 * args.rows // 3], X[:args.rows // 2], X]
    kw = dict(metric="l2", seed=0, backend="cuda")
    cold = BanditPAM(10, **kw).fit(X)
    runs = {
        "default": lambda: BanditPAM(10, **kw).fit(X),
        "replacement+leader": lambda: BanditPAM(
            10, sampling="replacement", baseline="leader", **kw).fit(X),
        "pic": lambda: BanditPAM(10, reuse="pic", **kw).fit(X),
        "warm start": lambda: BanditPAM(10, **kw).fit(
            X, warm_start=cold.medoids),
        "batch none": lambda: BanditPAM(10, **kw).fit_batch(lanes,
                                                            [0, 1, 2]),
        "batch pic": lambda: BanditPAM(10, reuse="pic", **kw).fit_batch(
            lanes, [0, 1, 2]),
    }
    found = 0
    for name, fn in runs.items():
        found += len(probe(torch, name, fn))
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=600))
    try:
        for reuse in ("none", "pic"):
            found += len(probe(torch, f"sharded {reuse}", lambda: (
                tdist.DistributedBanditPAM(10, reuse=reuse, **kw).fit(X))))
    finally:
        dist.destroy_process_group()
    print(card)
    print(f"[sync] {found} sync sites in all")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
