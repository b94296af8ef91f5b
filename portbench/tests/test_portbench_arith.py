"""The metric arithmetic on fixed numbers: the distance work's least
time, the roofline and idle shares, the union of device intervals and
the idle gaps by host operation."""

import importlib.util
from pathlib import Path

import pytest

from portbench import peaks, trace
from portbench.harness import Call, FitRecord, Run, fit_seed

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_distance_work():
    # 1e12 fresh evaluations at d = 784: 1.568e15 operations at 67 TF/s.
    assert peaks.distance_work_s(1e12, 0, 784) == pytest.approx(
        1.568e15 / 67e12)
    # 3.35e11 cached evaluations: 1.34e12 bytes at 3.35 TB/s.
    assert peaks.distance_work_s(0, 3.35e11, 784) == pytest.approx(0.4)
    assert peaks.bound_s(67e12, 1.0) == pytest.approx(1.0)


def test_roofline_and_idle_shares():
    run = Run({"d": 784}, {})
    run.trace = {"busy_s": 2.0, "window_s": 8.0, "fresh_evals": 2.3e9,
                 "cached_evals": 0}
    least = 2.3e9 * 2 * 784 / 67e12
    assert reader("dist_roofline")(run) == pytest.approx(100 * least / 2.0)
    assert reader("idle_share")(run) == pytest.approx(75.0)
    run.trace = None
    assert reader("dist_roofline")(run) is None
    assert reader("idle_share")(run) is None


def _fit(evals, cached, walls=None):
    rep = type("R", (), {})()
    rep.distance_evals, rep.cached_evals = evals, cached
    rep.evals_by_phase = {"build": evals, "build_cached": cached}
    rep.wall_by_phase = walls or {"build": 2.0, "swap": 1.0}
    rep.host_reads_by_phase = {"build": 10, "swap": 4}
    rep.dispatches_by_phase = {}
    return rep


def test_counter_readers():
    reps = [_fit(100, 0), _fit(300, 100)]
    run = Run({"d": 8}, {}, setup_s=12.5, wall_s=9.0,
              calls=[Call(r, [FitRecord(None, 0, r, None, "pic")])
                     for r in reps], peak_bytes=2 ** 31,
              launches={"build_g": 30, "swap_g": 10})
    assert reader("fit_s")(run) == pytest.approx(4.5)
    assert reader("setup_s")(run) == 12.5
    assert reader("peak_mem_gib")(run) == pytest.approx(2.0)
    assert reader("build_s")(run) == pytest.approx(2.0)
    assert reader("swap_s")(run) == pytest.approx(1.0)
    assert reader("evals_per_fit")(run) == pytest.approx(200)
    assert reader("host_reads_per_fit")(run) == pytest.approx(14)
    assert reader("launches_per_fit")(run) == pytest.approx(20)
    assert reader("cached_share")(run) == pytest.approx(20.0)
    assert reader("lockstep_rounds")(run) is None
    reps[0].dispatches_by_phase = {"build": 40, "swap": 20}
    assert reader("lockstep_rounds")(run) == pytest.approx(60)


def test_union_and_gaps():
    busy = trace.union([(0, 10), (5, 20), (30, 40), (41, 50), (60, 70)])
    assert busy == [(0, 20), (30, 40), (41, 50), (60, 70)]
    # Host: an op over [15, 35) holding a sync over [18, 32); a launch
    # over [45, 65).
    host = [(1, 15, 35, "aten::op"), (1, 18, 32, "cudaSync"),
            (1, 45, 65, "cudaLaunchKernel"), (2, 0, 100, "other thread")]
    gaps = dict(trace.gaps_by_host(busy, host))
    # Gaps: [20, 30) under cudaSync, [40, 41) under nothing on thread 1,
    # [50, 60) under the launch.
    assert gaps == {"cudaSync": 10e-9, "idle": 1e-9,
                    "cudaLaunchKernel": 10e-9}


def test_fit_seeds():
    a = [fit_seed(s, 1, i) for s in (0, 2 ** 31 + 1, 2 ** 40)
         for i in range(3)]
    assert len(set(a)) == len(a) and all(0 <= v < 2 ** 31 for v in a)
    assert fit_seed(-5, 1, 0) == fit_seed(-5, 1, 0)
