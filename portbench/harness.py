"""The benchmark of ``repro_torch``, driven by data.

``BENCHMARK.json`` at the repository root names the cells; everything of
one configuration, traffic mix, driver or metric sits in a file of its
own under ``portbench/``, found by the name the manifest gives:

* ``configs/<config>.json`` — the dataset and the fit's sizes
  (``"file"`` in the manifest's configuration entry);
* ``traffic/<mix>.json`` — the mix's parameters, among them ``"driver"``;
* ``drivers/<driver>.py`` — the general generator of a kind of call
  (``fit``, ``fit_batch``): a ``Job`` made from the configuration, the
  mix, the data and the seed, whose ``call(i)`` makes call ``i``;
* ``metrics/<metric>.py`` — ``read(run)``, the metric's value from the
  run's record (:class:`Run`), or None where there is nothing to read;
* ``limits/<workload>.json`` — the limits of the numbers ``check.py``
  compares in the cell.

A later change adds a configuration, a mix, a driver or a metric as new
files and new entries in the manifest, and edits no file here.

:func:`run_cell` is one run: the configuration's dataset, one warm-up
call (set-up), the measured window of back-to-back calls whose fit seeds
come from the run's seed, with ``trace`` one more call under the
profiler, then the check against the plain reference of a sample of
the window's fits (the mix's ``checked_fits``) or of every fit of a
sample of its calls (``checked_calls``: each lane of a batch).  The
set-up's parts (imports, the kernels' library, which ``nvcc`` builds on
a checkout's first run, the data, the warm-up) are logged and returned
under ``setup_parts``, beside ``setup_s``, which holds them all.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, data, trace

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Bench:
    """The manifest and the files it names, under ``root`` (a checkout's
    root)."""

    def __init__(self, root: Path = REPO):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def _pkg(self, *parts: str) -> Path:
        return self.root / "portbench" / Path(*parts)

    def cell(self, workload: str) -> dict:
        for c in self.manifest["workloads"]:
            if c["name"] == workload:
                return c
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return json.loads(self._pkg("traffic", f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads(self._pkg("limits", f"{workload}.json")
                          .read_text())["limits"]

    def _module(self, kind: str, name: str):
        path = self._pkg(kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        return self._module("drivers", name)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def metrics(self, workload: str, traced: bool) -> List[dict]:
        """The cell's metrics: its end-to-end ones untraced, its per-layer
        ones traced; a metric with ``workloads`` only in those cells."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.manifest[key]
                if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class FitRecord:
    """One fit a call made: its rows of the dataset (None: all), seed,
    report and in-sample labels, and its cache mode."""
    rows: Optional[np.ndarray]
    seed: int
    report: object
    labels: np.ndarray
    reuse: str


@dataclasses.dataclass
class Call:
    report: object                 # FitReport or BatchFitReport
    fits: List[FitRecord]


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    config: dict
    mix: dict
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    calls: List[Call] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None   # the traced call's summary

    @property
    def fits(self) -> List[FitRecord]:
        return [f for c in self.calls for f in c.fits]


def reuse_of(mix: dict) -> str:
    """The distance-cache mode of a mix's fits, as its ``params`` state
    it."""
    return mix.get("params", {}).get("reuse", "none")


def fit_seed(seed: int, *path: int) -> int:
    """A fit's seed from the run's seed and the fit's place in the run."""
    ss = np.random.SeedSequence([seed % 2 ** 63, *path])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, device="cuda",
             overrides: Optional[dict] = None):
    """One run of a cell; returns the result's object (without the
    device's description) and the run's record.  ``overrides`` replaces keys of the
    configuration (tests run small sizes on the CPU with it)."""
    from repro_torch.kernels import ops
    cell = bench.cell(workload)
    cfg = {**bench.config(cell["config"]), **(overrides or {})}
    mix = bench.mix(cell["traffic"])
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.lib()                        # nvcc on a checkout's first run
        parts["nvcc" if build.build_info.get("cached") is False
              else "library"] = time.perf_counter() - t
        t = time.perf_counter()
    x, labels = data.make(cfg)
    parts["data"] = time.perf_counter() - t
    t = time.perf_counter()
    job = bench.driver(mix["driver"]).Job(cfg, mix, x, labels, seed, device)
    job.call(None)                                   # warm-up
    _sync(device)
    parts["warm_up"] = time.perf_counter() - t
    run = Run(cfg, mix, setup_s=time.perf_counter() - t_start,
              setup_parts=parts)
    log(f"[run] {workload} seed {seed}: set-up {run.setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + ")")

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    failed = 0
    t0 = time.perf_counter()
    while True:
        try:
            run.calls.append(job.call(len(run.calls)))
        except Exception:                     # noqa: BLE001 - a failed fit
            log(traceback.format_exc())
            failed += 1
            break
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    run.wall_s = time.perf_counter() - t0
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    run.launches = ops.launch_counts()
    log(f"[run] window {run.wall_s:.3f} s, {len(run.calls)} calls, "
        f"{len(run.fits)} fits, peak {run.peak_bytes} B")
    if traced and not failed:
        call, run.trace = trace.traced(lambda: job.call(len(run.calls)),
                                       lambda: _sync(device))
        fits = call.fits
        run.trace["fresh_evals"] = sum(f.report.distance_evals for f in fits)
        run.trace["cached_evals"] = sum(f.report.cached_evals for f in fits)
        log(f"[run] traced call {run.trace['window_s']:.3f} s, device busy "
            f"{run.trace['busy_s']:.3f} s")
    del job
    if cuda:
        torch.cuda.empty_cache()

    # The check, after the window and the peak: a sample of the fits, or
    # every fit of a sample of the calls.
    if "checked_calls" in mix:
        first = np.cumsum([0] + [len(c.fits) for c in run.calls])
        picked = [j for c in check.sample(len(run.calls),
                                          int(mix["checked_calls"]), seed)
                  for j in range(first[c], first[c + 1])]
    else:
        picked = check.sample(len(run.fits), int(mix["checked_fits"]), seed)
    parts = []
    t1 = time.perf_counter()
    for i in picked:
        rec = run.fits[i]
        parts.append(check.judge_record(rec, x, cfg, device))
        log(f"[check] fit {i} (seed {rec.seed}): {parts[-1]}")
    log(f"[check] {len(picked)} fits in {time.perf_counter() - t1:.1f} s")
    limits = bench.limits(workload)
    checks = check.verdict(check.combine(parts), limits)
    wrong = sum(not check.passes(check.verdict(check.combine([p]), limits))
                for p in parts)
    correct = bool(picked) and not failed and not wrong

    metrics = {}
    for m in bench.metrics(workload, traced):
        v = bench.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(run.fits) + failed,
           "failed": failed + wrong, "metrics": metrics,
           "setup_parts": run.setup_parts}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out, run
