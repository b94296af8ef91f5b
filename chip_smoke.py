#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failure:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: the kernels are compiled by ``nvcc`` from ``repro_torch/kernels/
   csrc`` (one process per source, in parallel) and each kernel's
   registers, shared memory and spills from ``-Xptxas -v`` are printed;
3. every kernel against its plain PyTorch version on the card, at the
   main path's shapes on MNIST-sized data (plus the other metrics at a
   smaller n), with the tolerance stated below, the kernel's time, the
   plain version's time, the library call's time where there is one,
   and the bound;
4. fit parity on the card: ``backend="cuda"`` against ``backend="torch"``
   on the same permutations must give identical medoids, swap history,
   ledger and build rounds, and a loss within rtol 1e-5;
5. the main path at full size: ``KMedoids(k=10, solver="banditpam",
   metric="l2").fit`` on 60,000 MNIST-like points of d=784, then
   ``predict`` on 10,000 more, with every kernel's launch count from that
   run, which must be >= 1.

The last two lines are one JSON object per kernel and the device line.
Without a CUDA device, or without the package beside this script, it
exits with an error and prints no result.

Tolerances (kernel against plain, both float32 on the card).  The two
sum their dot products in different orders; over d = 784 terms the
worst-case relative error of a dot product or abs-sum is about
d·2^-24 < 1e-4, so a distance may differ by ``dtol = 1e-4·dmax``
(l2sq, l1, cosine) and, since sqrt turns an error e near 0 into sqrt(e),
by ``dtol = 1e-2·dmax`` for l2.  Distances are then held to
``dtol + 1e-5·|ref|``, the B-term sums to ``B·dtol`` (Σg), ``2B·dmax·dtol``
(Σg², Σg·g_lead for BUILD) and ``4B·dmax·dtol`` (SWAP, where g adds two
terms), and the top-2 labels must agree wherever the two nearest
distances are more than ``2·dtol`` apart (for l2: their squares more than
``2·1e-4·dmax²``, the l2sq tolerance).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3
B = 100                     # reference batch (BanditPAM's default)
N_FIT, N_QUERY = 60000, 10000   # MNIST's train / test split
N_SMALL = 8192              # rows for the other metrics' checks
N_PARITY = 4096             # rows of the cuda-vs-torch fit parity


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, CUDA events, warmed up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(flops: float, nbytes: float):
    tc = flops / PEAK_F32_FLOPS * 1e3
    tb = nbytes / PEAK_BYTES * 1e3
    return (tc, "operations") if tc >= tb else (tb, "bytes")


def dist_tol(metric: str, dmax: float) -> float:
    return (1e-2 if metric == "l2" else 1e-4) * dmax


def check_close(name, got, want, atol, rtol=1e-5):
    """Max abs error of ``got`` against ``want``; raises past
    ``atol + rtol·|want|`` or where the two differ in finiteness."""
    import torch
    fin = want.isfinite()
    if not torch.equal(got.isfinite(), fin) or not torch.equal(got[~fin],
                                                               want[~fin]):
        raise AssertionError(f"{name}: non-finite entries differ")
    g, w = got[fin].double(), want[fin].double()
    err = (g - w).abs()
    ratio = float((err / (atol + rtol * w.abs())).max()) if err.numel() else 0.0
    worst = float(err.max()) if err.numel() else 0.0
    log(f"[check] {name:28s} max_abs_err {worst:.3e}  err/limit {ratio:.3f}")
    if ratio > 1.0:
        raise AssertionError(f"{name}: beyond tolerance (atol {atol:.3e})")
    return worst


def clear_of_ties(metric, d1, d2, dmax):
    """Rows whose two nearest distances differ by more than twice the
    tolerance (in l2sq for l2, where the tolerance is stated)."""
    if metric == "l2":
        return (d2 * d2 - d1 * d1) > 2 * 1e-4 * dmax * dmax
    return (d2 - d1) > 2 * dist_tol(metric, dmax)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    log(f"[build] nvcc compile {build.build_info.get('compile_s', 0):.1f} s, "
        f"link {build.build_info.get('link_s', 0):.1f} s, total "
        f"{time.perf_counter() - t0:.1f} s (cached={build.build_info['cached']})")
    for src, out in sorted(build.build_info.get("ptxas", {}).items()):
        fn = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif fn and ("Used" in line or "spill" in line):
                log(f"[build] {src} {fn}: {line.split(':', 1)[-1].strip()}")


def kernel_checks(torch, X, dev):
    """Phase 3: each kernel against its plain version at the main path's
    shapes; returns the timing rows (l2, the main path's metric)."""
    from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    def stats_case(metric, n, k, d_all):
        x = d_all[:n].contiguous()
        ref = torch.randperm(n, generator=gen)[:B].to(dev)
        y = x[ref].contiguous()
        w = torch.ones(B, device=dev)
        w[-7:] = 0.0                                    # padded slots
        med = x[torch.randperm(n, generator=gen)[:k].to(dev)].contiguous()
        dxy = pairwise.pairwise_torch(y, med, metric=metric)
        dmax = float(pairwise.pairwise_torch(x[:2048], y, metric=metric).max())
        tol = dist_tol(metric, dmax)
        res = {}
        # BUILD, once with the first selection's dnear = inf, once finite.
        for label, dn in (("inf", torch.full((B,), float("inf"), device=dev)),
                          ("finite", dxy.min(dim=1).values.contiguous())):
            lg = (torch.clamp_max(dxy[:, 0] - dn, 0.0) if label == "finite"
                  else dxy[:, 0]).contiguous() * w
            got = ops.build_g_stats(x, y, dn, w, lg, metric=metric)
            want = build_g.build_g_torch(x, y, dn, w, lg, metric)
            e = [check_close(f"build_g[{metric},{label}] {nm}", g, wv, a)
                 for nm, g, wv, a in zip(("sums", "sq", "cross"), got, want,
                                         (B * tol, 2 * B * dmax * tol,
                                          2 * B * dmax * tol))]
            res[f"build_g/{label}"] = (max(e), x, y, dn, w, lg)
        # SWAP, with d1/d2/assign of the batch from the top-2 kernel.
        d1, d2, a = ops.stream_top2(y, med, metric=metric)
        lg = dxy[:, 0].contiguous()                     # a leader's g-row
        got = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
        want = swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg, metric)
        e = [check_close(f"swap_g[{metric}] {nm}", g, wv, at)
             for nm, g, wv, at in zip(("sums", "sq", "cross"), got, want,
                                      (2 * B * tol, 4 * B * dmax * tol,
                                       4 * B * dmax * tol))]
        res["swap_g"] = (max(e), x, y, d1, d2, a, w, k, lg)
        # top-2 over all n rows.
        got = ops.stream_top2(x, med, metric=metric)
        want = stream_g.top2_torch(x, med, metric)
        e1 = check_close(f"top2[{metric}] d1", got[0], want[0], tol)
        e2 = check_close(f"top2[{metric}] d2", got[1], want[1], tol)
        clear = clear_of_ties(metric, want[0], want[1], dmax)
        if not bool((got[2] == want[2])[clear].all()):
            raise AssertionError(f"top2[{metric}] labels differ off near-ties")
        res["top2"] = (max(e1, e2), x, med)
        return res, tol

    for metric, n in (("l2", N_FIT), ("l2sq", N_SMALL), ("l1", N_SMALL),
                      ("cosine", N_SMALL)):
        res, tol = stats_case(metric, n, 10, X)
        # pairwise at predict's shape: 10,000 queries x 10 medoids.
        q = (X[N_FIT:N_FIT + N_QUERY] if metric == "l2" else X[:2000]).contiguous()
        med = res["top2"][2]
        got = ops.pairwise_distance(q, med, metric)
        want = pairwise.pairwise_torch(q, med, metric=metric)
        ep = check_close(f"pairwise[{metric}]", got, want, tol)
        # and at the BUILD d_near update's shape: one medoid row x all n.
        x = res["top2"][1]
        ep = max(ep, check_close(
            f"pairwise[{metric}] d_near", ops.pairwise_distance(
                x[:1], x, metric), pairwise.pairwise_torch(x[:1], x,
                                                           metric=metric), tol))
        log(f"[kernel] {metric}: all kernels within tolerance (distance "
            f"tolerance {tol:.3e}, max distance {float(want.max()):.3e})")
        if metric == "l2":
            rows = time_rows(torch, res, q, med, ep)
    return rows


def time_rows(torch, res, q, med, pairwise_err):
    from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
    out = []
    _, x, y, dn, w, lg = res["build_g/finite"]
    n, d = x.shape
    fl, by = 2.0 * n * B * d, 4.0 * (n * d + B * d + 3 * B + 3 * n)
    out.append(("build_g", "repro_torch/kernels/csrc/build_g.cu",
                "src/repro/kernels/build_g.py:42",
                max(res["build_g/inf"][0], res["build_g/finite"][0]),
                lambda: ops.build_g_stats(x, y, dn, w, lg, metric="l2"),
                lambda: build_g.build_g_torch(x, y, dn, w, lg, "l2"),
                None, fl, by))
    err, x, y, d1, d2, a, w, k, lg = res["swap_g"]
    fl, by = 2.0 * n * B * d, 4.0 * (n * d + B * d + 5 * B + 3 * k * n)
    out.append(("swap_g", "repro_torch/kernels/csrc/swap_g.cu",
                "src/repro/kernels/swap_g.py:85", err,
                lambda: ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric="l2"),
                lambda: swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg, "l2"),
                None, fl, by))
    err, x, m = res["top2"]
    k = m.shape[0]
    fl, by = 2.0 * n * k * d, 4.0 * (n * d + k * d + 3 * n)
    out.append(("top2", "repro_torch/kernels/csrc/stream_g.cu",
                "src/repro/kernels/stream_g.py:165", err,
                lambda: ops.stream_top2(x, m, metric="l2"),
                lambda: stream_g.top2_torch(x, m, "l2"),
                None, fl, by))
    mq, k = q.shape[0], med.shape[0]
    fl, by = 2.0 * mq * k * d, 4.0 * (mq * d + k * d + mq * k)
    out.append(("pairwise", "repro_torch/kernels/csrc/pairwise.cu",
                "src/repro/kernels/pairwise.py:74", pairwise_err,
                lambda: ops.pairwise_distance(q, med, "l2"),
                lambda: pairwise.pairwise_torch(q, med, metric="l2"),
                lambda: torch.cdist(q, med), fl, by))
    rows = []
    for name, src, rep, err, kern, plain, lib, fl, by in out:
        ms = time_ms(kern)
        pms = time_ms(plain)
        lms = time_ms(lib) if lib is not None else None
        bms, bby = bound_ms(fl, by)
        log(f"[time] {name:9s} kernel {ms:.4f} ms  plain {pms:.4f} ms  "
            f"library {'-' if lms is None else f'{lms:.4f} ms'}  bound "
            f"{bms * 1e3:.1f} us ({bby})  share of bound {bms / ms:.3f}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": lms})
    return rows


def fit_parity(torch, X, dev):
    """Phase 4: backend="cuda" against backend="torch" on the card."""
    import numpy as np
    from repro_torch.core import BanditPAM, rng
    n, k = N_PARITY, 5
    data = X[:n].contiguous()
    prng = np.random.default_rng(1)
    perms = (np.stack([prng.permutation(n) for _ in range(k)]),
             np.stack([prng.permutation(n) for _ in range(4 * k + 10)]))
    fits = {}
    for be in ("cuda", "torch"):
        t0 = time.perf_counter()
        fits[be] = BanditPAM(k, metric="l2", backend=be, device=dev).fit(
            data, layouts=rng.from_numpy(*perms))
        log(f"[parity] backend={be:5s} medoids {fits[be].medoids.tolist()} "
            f"loss {fits[be].loss!r} swaps {fits[be].n_swaps} evals "
            f"{fits[be].evals_by_phase} ({time.perf_counter() - t0:.2f} s)")
    a, b = fits["cuda"], fits["torch"]
    same = (a.medoids.tolist() == b.medoids.tolist()
            and [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
            and a.evals_by_phase == b.evals_by_phase
            and a.build_rounds == b.build_rounds and a.n_swaps == b.n_swaps
            and a.converged == b.converged)
    if not same or abs(a.loss - b.loss) > 1e-5 * abs(b.loss):
        raise AssertionError("cuda and torch fits differ")
    log("[parity] cuda == torch: medoids, swap history, ledger, build rounds, "
        f"n_swaps, converged; loss rel diff {abs(a.loss - b.loss) / abs(b.loss):.2e}")


def main_path(torch, X, dev, Xnp):
    """Phase 5: the user's call at full size; returns launch counts."""
    from repro_torch.api import KMedoids
    from repro_torch.core import total_loss
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    est = KMedoids(k=10, solver="banditpam", metric="l2", seed=0)
    est.fit(Xnp[:N_FIT])
    fit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = est.predict(Xnp[N_FIT:N_FIT + N_QUERY])
    predict_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    r = est.report_
    log(f"[main] medoids {r.medoids.tolist()}")
    log(f"[main] loss {r.loss!r} n_swaps {r.n_swaps} converged {r.converged}")
    log(f"[main] evals_by_phase {r.evals_by_phase} build_rounds {r.build_rounds}")
    log(f"[main] wall_by_phase {r.wall_by_phase} fit {fit_s:.3f} s "
        f"(data upload included)")
    log(f"[main] predict {N_QUERY} rows {predict_ms:.3f} ms; peak device memory "
        f"{peak} bytes")
    log(f"[main] kernel launches {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran: {counts}")
    # Output checks: shapes, finiteness, the loss against a plain pass, the
    # labels against the plain argmin off near-ties.
    if len(set(r.medoids.tolist())) != 10 or est.labels_.shape != (N_FIT,):
        raise AssertionError("bad medoids or labels")
    data = X[:N_FIT].contiguous()
    med_t = torch.as_tensor(r.medoids, device=dev)
    plain_loss = float(total_loss(data, med_t, metric="l2", backend="torch"))
    if abs(plain_loss - r.loss) > 1e-5 * abs(plain_loss):
        raise AssertionError(f"loss {r.loss} != plain {plain_loss}")
    from repro_torch.core.distances import l2
    dq = l2(X[N_FIT:N_FIT + N_QUERY], data[med_t])
    want = torch.argmin(dq, dim=1).cpu().numpy()
    top = torch.topk(dq, 2, dim=1, largest=False).values
    clear = clear_of_ties("l2", top[:, 0], top[:, 1],
                          float(dq.max())).cpu().numpy()
    if labels.shape != (N_QUERY,) or not (labels == want)[clear].all():
        raise AssertionError("predict labels differ from the plain argmin")
    log(f"[main] predict labels == plain argmin on {int(clear.sum())} of "
        f"{N_QUERY} rows (the rest are near-ties)")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "repro_torch", "kernels", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(repro_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from repro_torch.core.datasets import mnist_like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    phase_build()
    t0 = time.perf_counter()
    Xnp = mnist_like(N_FIT + N_QUERY, seed=0)
    X = torch.from_numpy(Xnp).to(dev)
    log(f"[data] mnist_like({N_FIT + N_QUERY}, d=784) made in "
        f"{time.perf_counter() - t0:.1f} s")
    rows = kernel_checks(torch, X, dev)
    fit_parity(torch, X, dev)
    counts = main_path(torch, X, dev, Xnp)
    for row in rows:
        row["launches"] = counts[row["name"]]
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
