"""Readings that set a cell's limits: the program's numbers and the
control's on the same fits, at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--control-kind tf32|tf32_stats] \
        [--out chiprun_out/control.jsonl]

For each seed, the cell's driver makes its first window call on the
configuration's dataset with that seed's fit seeds, and ``check.judge``
gives the numbers of each of its fits (the program's readings).  For
each control seed, the reference takes the program's place on the same
fits, seeds and rows, computed in TF32, the step below the
configuration's float32 (``Space``'s ``"tf32"``: l2 as ``torch.cdist``
takes it under TF32, l1 over operands rounded to TF32, the bandit's
arithmetic in float32), and ``check.judge`` gives its numbers too (the
control's readings, which the limits must reject).  With
``--control-kind tf32_stats`` only the searches' statistics are TF32
(as a kernel that ran its Σg on tensor cores would give them), while
the nearest medoids, the losses, the swaps' acceptance and the labels
are float32: a control shaped like the program, whose readings show
what the numbers compared can see of the statistics alone.  One JSON
line per fit and side.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_report(space, k: int, seed: int, batch_size: int, reuse: str,
                   exact=None):
    """The reference in the program's place: its walk with statistics in
    ``space``'s precision and the rest in ``exact``'s (default: the
    same), as a report with in-sample labels of ``exact``'s precision."""
    import torch
    from portbench.reference.bandit import walk
    exact = space if exact is None else exact
    w = walk(space, k, seed, batch_size=batch_size, reuse=reuse,
             exact=exact)
    labels = torch.argmin(exact.to_medoids(w.medoids), dim=1).cpu().numpy()
    fresh = sum(v for p, v in w.evals_by_phase.items()
                if not p.endswith("_cached"))
    rep = types.SimpleNamespace(
        medoids=w.medoids, loss=w.loss, swap_history=w.history,
        build_rounds=w.build_rounds, evals_by_phase=w.evals_by_phase,
        converged=w.converged, n_swaps=len(w.history), distance_evals=fresh,
        cached_evals=sum(w.evals_by_phase.values()) - fresh)
    return rep, labels


def readings(bench, workload: str, seed: int, control: bool, device,
             overrides=None, kind: str = "tf32"):
    """The numbers of each fit of the cell's first window call for
    ``seed``: the program's, or (``control``) the TF32 reference's in its
    place (``kind`` ``"tf32_stats"``: TF32 statistics alone)."""
    import numpy as np
    from portbench import check, data
    from portbench.reference.bandit import Space
    cell = bench.cell(workload)
    cfg = {**bench.config(cell["config"]), **(overrides or {})}
    mix = bench.mix(cell["traffic"])
    x, labels = data.make(cfg)
    job = bench.driver(mix["driver"]).Job(cfg, mix, x, labels, seed, device)
    call = job.call(0)
    del job
    out = []
    for i, rec in enumerate(call.fits):
        t0 = time.perf_counter()
        if control:
            rows = x if rec.rows is None else x[rec.rows]
            rows = np.ascontiguousarray(rows)
            space = Space(rows, cfg["metric"], "tf32", device)
            exact = (Space(rows, cfg["metric"], "float32", device)
                     if kind == "tf32_stats" else None)
            rep, lab = control_report(space, int(cfg["k"]), rec.seed,
                                      int(cfg["batch_size"]), rec.reuse,
                                      exact=exact)
            rec = type(rec)(rec.rows, rec.seed, rep, lab, rec.reuse)
        nums = check.judge_record(rec, x, cfg, device)
        out.append({"workload": workload, "seed": seed, "fit": i,
                    "side": kind if control else "program",
                    "swaps": int(rec.report.n_swaps),
                    "seconds": time.perf_counter() - t0, **nums})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-kind", choices=("tf32", "tf32_stats"),
                    default="tf32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the readings are the card's")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.Bench(ROOT)
    sink = open(args.out, "a") if args.out else None
    jobs = [(int(s), False) for s in args.seeds.split(",") if s]
    jobs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, ctl in jobs:
        for line in readings(bench, args.workload, seed, ctl, "cuda",
                             kind=args.control_kind):
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
