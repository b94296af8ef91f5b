#!/usr/bin/env python3
"""Time full-size fits of this checkout against another checkout's on one
NVIDIA GPU, in turns, and check that the two give the same reports.

Run from the repository root, with the other checkout unpacked in a
directory (for example the parent commit, from ``git archive``)::

    python3 chip_fit_ab.py --base build/parent

Each turn is one process that imports the ``repro_torch`` of one
checkout (built by its own ``repro_torch/kernels/build.py``) and fits
``mnist_like(60000, seed=0)`` (d = 784, k = 10, l2, seed 0) in each
configuration of ``--fits`` (all by default):

* ``pic``: ``KMedoids(k=10, reuse="pic")``, the default 32-round ring;
* ``pic_full``: ``reuse="pic", cache_width=60000, cache_cols=3200``;
* ``pic_stepped``: ``pic`` with ``fused=False``;
* ``replacement``: ``sampling="replacement", baseline="leader"``;
* ``serve``: ``MedoidService(10, "l2").fit``, the service's initial fit;
* ``batch``, ``batch_pp``: ``KMedoids(k=5, solver="banditpam")`` and
  ``solver="banditpam_pp"`` ``.fit_batch`` (the leader) on
  ``chip_smoke.py`` phase 8 (a)'s 64 fits of ``mnist_like(256,
  seed=i)``, seeds 0-63;
* ``ragged``, ``ragged_pp``: the same at k = 10 on phase 8 (b)'s 8 ragged
  fits of ``mnist_like(5,000 + 1,037·i, seed=100 + i)``, seeds 0-7;
* ``dist``, ``dist_pic``: ``KMedoids(k=10, solver="banditpam_dist")``
  (B = 128), ``reuse="none"`` and ``"pic"``, at world size 1 on nccl
  (``chip_smoke.py`` phase 9 (a)'s fits; the turn's process starts the
  one-rank group before its first sharded fit).

The turns run base, change, change, base.  Each fit prints its wall by
phase and host reads by phase; the two checkouts' medoids, swaps, build
rounds, ledgers and losses must be equal (raising).  Prints the card's
name and power limit and, as its last line, one JSON object with every
fit of every turn.  Exits with an error without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FITS = ("pic", "pic_full", "pic_stepped", "replacement", "serve", "batch",
        "batch_pp", "ragged", "ragged_pp", "dist", "dist_pic")
N_FIT = 60000
# Phase 8's batches of chip_smoke.py: (fits' n, k).
BATCHES = {"batch": ((256,) * 64, 5),
           "ragged": (tuple(5000 + 1037 * i for i in range(8)), 10)}


def world1() -> None:
    """A one-rank nccl group for the sharded fits, on a free local port."""
    import datetime
    import socket
    import torch
    import torch.distributed as dist
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=600))
    dist.all_reduce(torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()


def worker(root: str, fits) -> None:
    """One turn: the fits of ``fits`` with ``root``'s package, one JSON
    line each."""
    sys.path.insert(0, root)
    import torch
    from repro_torch.api import KMedoids
    from repro_torch.core.datasets import mnist_like
    from repro_torch.kernels import build
    from repro_torch.serve import MedoidService
    torch.backends.cuda.matmul.allow_tf32 = False
    build.lib()
    X = mnist_like(N_FIT, seed=0)
    kws = {"pic": dict(reuse="pic"),
           "pic_full": dict(reuse="pic", cache_width=N_FIT, cache_cols=3200),
           "pic_stepped": dict(reuse="pic", fused=False),
           "replacement": dict(sampling="replacement", baseline="leader"),
           "dist": dict(solver="banditpam_dist"),
           "dist_pic": dict(solver="banditpam_dist", reuse="pic")}
    if any(f.startswith("dist") for f in fits):
        world1()
    def summary(r):
        return [r.medoids.tolist(), [h[:2] for h in r.swap_history],
                r.build_rounds, r.evals_by_phase, float(r.loss)]

    for name in fits:
        batch = BATCHES.get(name.replace("_pp", ""))
        if batch is not None:
            ns, k = batch
            seed0 = 0 if len(set(ns)) == 1 else 100
            Xs = [mnist_like(n, seed=seed0 + i) for i, n in enumerate(ns)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "serve":
            r = MedoidService(10, "l2").fit(X).last_report
        elif batch is not None:
            solver = "banditpam_pp" if name.endswith("_pp") else "banditpam"
            r = KMedoids(k=k, solver=solver, metric="l2", seed=0,
                         baseline="leader").fit_batch(
                             Xs, seeds=list(range(len(ns))))
        else:
            r = KMedoids(k=10, metric="l2", seed=0, **kws[name]).fit(
                X).report_
        torch.cuda.synchronize()
        print(json.dumps({
            "fit": name, "call_s": time.perf_counter() - t0,
            "wall_by_phase": r.wall_by_phase,
            "host_reads_by_phase": r.host_reads_by_phase,
            "report": ([summary(f) for f in r] if batch is not None
                       else summary(r))}),
            flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--fits", default=",".join(FITS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    fits = [f for f in args.fits.split(",") if f]
    if any(f not in FITS for f in fits):
        ap.error(f"--fits takes {FITS}")
    if args.worker:
        worker(args.worker, fits)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_fit_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.base or not os.path.isdir(os.path.join(args.base,
                                                       "repro_torch")):
        ap.error("--base must be a checkout with repro_torch/")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    roots = {"base": os.path.abspath(args.base), "change": ROOT}
    out = []
    for turn, side in enumerate(("base", "change", "change", "base")):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[side], "--fits", ",".join(fits)],
            capture_output=True, text=True, timeout=1800, cwd=roots[side])
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"turn {turn} ({side}) failed")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = dict(json.loads(line), side=side, turn=turn)
                out.append(rec)
                print(f"[ab] turn {turn} {side:6s} {rec['fit']:12s} "
                      f"wall_by_phase {rec['wall_by_phase']} "
                      f"host_reads_by_phase {rec['host_reads_by_phase']} "
                      f"call {rec['call_s']:.3f} s", flush=True)
    for name in fits:
        reps = {json.dumps(r["report"]) for r in out if r["fit"] == name}
        print(f"[ab] {name}: the same report in every turn: "
              f"{len(reps) == 1}", flush=True)
        if len(reps) != 1:
            raise AssertionError(f"{name}: the reports differ")
    print(card)
    print(json.dumps({"card": card, "fits": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
