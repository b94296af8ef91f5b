#!/usr/bin/env python3
"""Time the port's kernels of this checkout against another checkout's
on one NVIDIA GPU, in turns, and check that the two give equal bits.

Run from the repository root, with the other checkout unpacked in a
directory (for example the parent commit, from ``git archive``)::

    python3 chip_ab.py --base build/parent

Both kernel libraries are built by their own ``repro_torch/kernels/
build.py`` from their own sources (the base's into its own ``build/``)
and called through the C interface the two share (``rt_pairwise``,
``rt_build_g``, ``rt_swap_g``, ``rt_stream_build_g``,
``rt_stream_swap_g``, ``rt_swap_g_from_cache``, ``rt_top2``), on the same
inputs:
``mnist_like`` rows at MNIST's size (d = 784) and the shapes the main
path gives each kernel (``rt_pairwise`` also at the sharded round's
[60,000 x 128], once through ``rt_pairwise`` and once in the 128 x 128
tile through ``rt_pairwise_tiled`` where a checkout has that entry, a
base without it taking ``rt_pairwise``; ``rt_swap_g`` also at k = 64 and
B = 300; the
streaming kernels at m = 60,000 and r = 100, 6,000 and 60,000, k = 10,
and ``rt_stream_swap_g`` at r = 6,000, k = 64 too; ``rt_swap_g_from_cache``
at a PIC round's [60,000 x 100] block and over a full [60,000 x 60,000]
ring with 5 % of the weights set, the carried-moment repair; ``rt_top2``
at n = 60,000 and k = 1, 10, 17, 40, 65 and 200, at predict's
[10,000 x 10] and at d = 783, which takes the 4-byte copies).  A
checkout whose entries take the run flag gets it at 1 (a device int),
as the device-resident fit passes it, and ``rt_pairwise`` its output's
row stride at r; one whose ``rt_swap_g`` and ``rt_stream_swap_g`` take
their bin scratch gets it from PyTorch's allocator (``scratched``).  Each
case is timed base, change, change, base (CUDA events, ``--reps``
launches after 3 warm-up launches each; fewer after one for the
streaming cases at r = 6,000 and, 2, at r = 60,000, the full exact
pass of about 0.2-0.5 s a launch, and 5 over the full ring) and the
two outputs must be equal bit for bit.  ``--only top2`` (a kernel
name, repeatable) runs that kernel's cases alone; ``--metric`` (l2 by
default, or l2sq, cosine, l1) is the metric of every case.
Prints the card's name and power limit and, as its last line, one JSON
object with every case.  Exits with an error without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
METRIC_IDS = {"l2": 0, "l2sq": 1, "cosine": 2, "l1": 3}
EXACT_REPS = 2  # launches a turn of the full exact pass (r = 60,000)


def log(*a):
    print(*a, flush=True)


def load_build(checkout: str, name: str):
    """The ``build`` module of a checkout, imported under ``name``."""
    path = os.path.join(checkout, "repro_torch", "kernels", "build.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_ms(torch, fn, reps: int, warm: int = 3) -> float:
    for _ in range(warm):
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


def cases(torch, X, reps, only=(), metric_id=0):
    """(name, shape, make outputs, call(lib, outputs, stream), reps,
    warm-up launches), of the kernels named in ``only`` (all if empty),
    every distance in the metric ``metric_id``."""
    p = lambda t: t.data_ptr()
    gen = torch.Generator(device="cpu").manual_seed(0)
    flag = torch.ones(1, dtype=torch.int32, device=X.device)

    def flagged(fn, *args):
        """Call a kernel with the run flag at 1 before the stream, as the
        device-resident fit passes it, where the checkout's kernel takes
        one; a base from before the flag gets none (kept while such bases
        are compared)."""
        if len(fn.argtypes) == len(args) + 1:
            args = args[:-1] + (p(flag), args[-1])
        return fn(*args)

    def scratched(lib, fn, args, m, r, k, period):
        """A swap_g kernel entry with the run flag at 1 and, where the
        checkout's entry takes its bin scratch, the scratch, allocated
        here at the size the checkout's ``rt_swap_g_scratch`` gives (the
        wide tile, one lane); a base from before allocates its own."""
        if not hasattr(lib, "rt_swap_g_scratch"):
            return flagged(fn, *args)
        floats = ctypes.c_int64(0)
        code = lib.rt_swap_g_scratch(m, r, k, period, metric_id, 1, 0,
                                     ctypes.byref(floats))
        if code != 0:
            return code
        sc = (torch.empty(floats.value, device=X.device) if floats.value
              else None)
        return fn(*args[:-1], p(flag), None if sc is None else p(sc),
                  floats.value, args[-1])

    n_fit = 60000
    x = X[:n_fit]
    q = X[n_fit:n_fit + 10000]
    d = x.shape[1]

    def rows(k):
        idx = torch.randperm(n_fit, generator=gen)[:k].to(X.device)
        return x[idx].contiguous()

    def pairwise(a, b, tiled=None):
        """``tiled``: a shape index that a checkout with the tiled entry
        (``rt_pairwise_tiled``) launches; one without takes
        ``rt_pairwise``'s own shape.  The bits must agree either way."""
        def make():
            return [torch.empty((a.shape[0], b.shape[0]), device=X.device)]

        def call(lib, outs, st):
            if tiled is not None and hasattr(lib, "rt_pairwise_tiled"):
                return lib.rt_pairwise_tiled(
                    p(a), p(b), p(outs[0]), a.shape[0], b.shape[0],
                    b.shape[0], d, metric_id, p(flag), tiled, st)
            fn = lib.rt_pairwise
            if len(fn.argtypes) == 8:   # a base without ldo and the flag
                return fn(p(a), p(b), p(outs[0]), a.shape[0], b.shape[0], d,
                          metric_id, st)
            return fn(p(a), p(b), p(outs[0]), a.shape[0], b.shape[0],
                      b.shape[0], d, metric_id, p(flag), st)
        return make, call

    def build_g(b):
        y = rows(b)
        dn = (torch.rand(b, generator=gen) * 0.5).to(X.device)
        dn[::7] = float("inf")
        w = torch.ones(b, device=X.device)
        w[-7:] = 0.0
        lg = torch.randn(b, generator=gen).to(X.device)

        def make():
            return [torch.empty(n_fit, device=X.device) for _ in range(3)]

        def call(lib, o, st):
            return flagged(lib.rt_build_g, p(x), p(y), p(dn), p(w), p(lg),
                           p(o[0]), p(o[1]), p(o[2]), n_fit, b, d, metric_id,
                           st)
        return make, call

    def swap_g(b, k):
        y = rows(b)
        dd = torch.cdist(y, rows(k))
        top = torch.topk(dd, min(2, k), dim=1, largest=False)
        d1 = top.values[:, 0].contiguous()
        d2 = (top.values[:, 1] if k > 1 else d1 * 2).contiguous()
        a = top.indices[:, 0].to(torch.int32).contiguous()
        w = torch.ones(b, device=X.device)
        w[-7:] = 0.0
        lg = torch.randn(b, generator=gen).to(X.device)

        def make():
            return [torch.empty((k, n_fit), device=X.device)
                    for _ in range(3)]

        def call(lib, o, st):
            return scratched(lib, lib.rt_swap_g, (
                p(x), p(y), p(d1), p(d2), p(a), p(w), p(lg), p(o[0]),
                p(o[1]), p(o[2]), n_fit, b, d, k, metric_id, st), n_fit, b,
                k, b)
        return make, call

    def stream_build_g(r):
        y = x[:r]
        dn = (torch.rand(r, generator=gen) * 0.5).to(X.device)
        dn[::7] = float("inf")
        w = torch.ones(r, device=X.device)
        w[::97] = 0.0
        lg = torch.randn(r, generator=gen).to(X.device)

        def make():
            return [torch.empty(n_fit, device=X.device) for _ in range(3)]

        def call(lib, o, st):
            return flagged(lib.rt_stream_build_g, p(x), p(y), p(dn), p(w),
                           p(lg), p(o[0]), p(o[1]), p(o[2]), n_fit, r, d,
                           metric_id, st)
        return make, call

    def top2(yy, k):
        top = torch.topk(torch.cdist(yy, rows(k)), min(2, k), dim=1,
                         largest=False)
        d1 = top.values[:, 0].contiguous()
        d2 = (top.values[:, 1] if k > 1 else d1 * 2).contiguous()
        return d1, d2, top.indices[:, 0].to(torch.int32).contiguous()

    def stream_swap_g(r, k):
        y = x[:r]
        d1, d2, a = top2(y, k)
        w = torch.ones(r, device=X.device)
        w[::97] = 0.0
        lg = torch.randn(r, generator=gen).to(X.device)

        def make():
            return [torch.empty((k, n_fit), device=X.device)
                    for _ in range(3)]

        def call(lib, o, st):
            return scratched(lib, lib.rt_stream_swap_g, (
                p(x), p(y), p(d1), p(d2), p(a), p(w), p(lg), p(o[0]),
                p(o[1]), p(o[2]), n_fit, r, d, k, metric_id, st), n_fit, r,
                k, 512)
        return make, call

    def top2_case(xx, k, dd=d):
        xx = xx[:, :dd].contiguous()
        mm = rows(k)[:, :dd].contiguous()
        m = xx.shape[0]

        def make():
            return [torch.empty(m, device=X.device),
                    torch.empty(m, device=X.device),
                    torch.empty(m, dtype=torch.int32, device=X.device)]

        def call(lib, o, st):
            return lib.rt_top2(p(xx), p(mm), p(o[0]), p(o[1]), p(o[2]), m,
                               k, dd, metric_id, st)
        return make, call

    def swap_g_from_cache(dxy, yy, k, w_share):
        b = dxy.shape[1]
        d1, d2, a = top2(yy, k)
        w = (torch.rand(b, generator=gen) < w_share).float().to(X.device)
        w[-7:] = 0.0
        lg = torch.randn(b, generator=gen).to(X.device)

        def make():
            return [torch.empty((k, n_fit), device=X.device)
                    for _ in range(3)]

        def call(lib, o, st):
            return flagged(
                lib.rt_swap_g_from_cache, p(dxy), dxy.stride(0), p(d1),
                p(d2), p(a), p(w), p(lg), p(o[0]), p(o[1]), p(o[2]), n_fit,
                b, k, st)
        return make, call

    med = rows(10)
    yr = rows(100)
    out = [("pairwise", "60000x100 (PIC round)", *pairwise(x, rows(100))),
           ("pairwise", "60000x3200 (ring fill)", *pairwise(x, rows(3200))),
           ("pairwise", "10000x10 (predict)", *pairwise(q, med)),
           ("pairwise", "1x60000 (d_near row)", *pairwise(x[:1], x)),
           ("pairwise", "1x100 (leader row)", *pairwise(x[5:6], rows(100))),
           # The sharded round's block (ROADMAP B14): through rt_pairwise
           # (two 104-column tiles in both), then in the 128 x 128 tile
           # (shape 5 of tuning.PAIRWISE_SHAPES) where a checkout has it.
           ("pairwise", "60000x128 (sharded round)",
            *pairwise(x, rows(128))),
           ("pairwise", "60000x128 (sharded round, 128x128 tile where "
            "tiled)", *pairwise(x, rows(128), tiled=5)),
           ("build_g", "60000x100 (BUILD round)", *build_g(100)),
           ("build_g", "60000x300", *build_g(300)),
           ("swap_g", "60000x100 k=10 (SWAP round)", *swap_g(100, 10)),
           ("swap_g", "60000x100 k=64", *swap_g(100, 64)),
           ("swap_g", "60000x300 k=10", *swap_g(300, 10))]
    out += [("top2", f"60000x{k}" + (" (fit)" if k == 10 else ""),
             *top2_case(x, k)) for k in (1, 10, 17, 40, 65, 200)]
    out += [("top2", "10000x10 (predict)", *top2_case(q, 10)),
            ("top2", "60000x10 d=783", *top2_case(x, 10, d - 1))]
    out = [c + (reps, 3) for c in out]
    out += [("stream_build_g", "60000x100", *stream_build_g(100), reps, 3),
            ("stream_build_g", "60000x6000", *stream_build_g(6000),
             max(2, reps // 4), 1),
            ("stream_build_g", "60000x60000 (exact pass)",
             *stream_build_g(n_fit), EXACT_REPS, 1),
            ("stream_swap_g", "60000x100 k=10", *stream_swap_g(100, 10),
             reps, 3),
            ("stream_swap_g", "60000x6000 k=10", *stream_swap_g(6000, 10),
             max(2, reps // 4), 1),
            ("stream_swap_g", "60000x6000 k=64", *stream_swap_g(6000, 64),
             max(2, reps // 4), 1),
            ("stream_swap_g", "60000x60000 k=10 (exact pass)",
             *stream_swap_g(n_fit, 10), EXACT_REPS, 1),
            ("swap_g_from_cache", "60000x100 k=10 (PIC round)",
             *swap_g_from_cache(torch.cdist(x, yr), yr, 10, 1.0), reps, 3)]
    if not only or "swap_g_from_cache" in only:
        # A full ring's worth of distances: the real ones for 3,200
        # columns, repeated (its values only need to be the same on both
        # sides).
        ring = torch.empty((n_fit, n_fit), device=X.device)
        for j in range(0, n_fit, 3200):
            w_ = min(3200, n_fit - j)
            ring[:, j:j + w_] = torch.cdist(x, x[j:j + w_])
        out.append(("swap_g_from_cache", "60000x60000 k=10, 5% w (repair)",
                    *swap_g_from_cache(ring, x, 10, 0.05), 5, 1))
    return [c for c in out if not only or c[0] in only]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="directory of the checkout to compare against")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", action="append", default=[],
                    help="run only this kernel's cases (repeatable)")
    ap.add_argument("--metric", choices=sorted(METRIC_IDS), default="l2")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from repro_torch.core.datasets import mnist_like
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    libs = {}
    for label, path in (("base", os.path.abspath(args.base)),
                        ("change", ROOT)):
        mod = load_build(path, f"ab_build_{label}")
        libs[label] = mod.lib()
        log(f"[ab] {label}: {path} built "
            f"(cached={mod.build_info.get('cached')})")
    X = torch.from_numpy(mnist_like(70000, seed=0)).cuda()
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    results = []
    for name, shape, make, call, reps, warm in cases(
            torch, X, args.reps, args.only, METRIC_IDS[args.metric]):
        outs = {lab: make() for lab in libs}
        for lab, lib in libs.items():
            code = call(lib, outs[lab], st)
            if code != 0:
                raise RuntimeError(f"{name} {shape} {lab}: CUDA error {code}")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b)
                   for a, b in zip(outs["base"], outs["change"]))
        t = {"base": [], "change": []}
        for lab in ("base", "change", "change", "base"):
            t[lab].append(time_ms(torch, lambda: call(libs[lab], outs[lab],
                                                      st), reps, warm))
        row = {"kernel": name, "shape": shape, "equal_bits": same,
               "base_ms": t["base"], "change_ms": t["change"]}
        results.append(row)
        log(f"[ab] {name:14s} {shape:27s} base {t['base']} ms  change "
            f"{t['change']} ms  equal bits {same}")
    log(card)
    log(json.dumps({"card": card, "cases": results}))
    return 0 if all(r["equal_bits"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
