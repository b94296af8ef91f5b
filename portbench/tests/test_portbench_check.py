"""The check that decides ``correct``, on the CPU at a size a test run
holds: a sound run of the port comes out correct; with the timed path
broken underneath (each fault a cell can have: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced: a label, a medoid) it comes out not correct;
and the control, the reference in the program's place in TF32, fails
the cell's limits.  The harness's look for a card is skipped: the port
runs its plain path."""

import time

import pytest
import torch

from portbench import check, harness
from portbench.control import readings
from repro_torch.core import engine

SMALL = {"mnist70k_l2_k10.fit": {"n": 3000},
         "scrna68k_l1_k5.fit": {"n": 1500},
         "scrna68k_l1_k5.pp": {"n": 1500},
         "scrna68k_l1_k5.batch": {"n": 1600}}


def run(workload, seed=2 ** 31 + 99):
    out, _ = harness.run_cell(harness.Bench(), workload, seed, 0.5, False,
                              time.perf_counter(), device="cpu",
                              overrides=SMALL[workload])
    return out


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def _stale_dnear(monkeypatch):
    """BUILD's nearest-medoid state returns unchanged: the one-row
    pairwise update of d_near (a lane's, in a batch) gives +inf."""
    orig = engine.TorchStatsBackend.pairwise
    orig_lanes = engine.TorchStatsBackend.pairwise_lanes

    def pairwise(self, x, y, *, metric, out=None, run=None):
        d = orig(self, x, y, metric=metric, out=out, run=run)
        return torch.full_like(d, float("inf")) if x.shape[0] == 1 else d

    def pairwise_lanes(self, x, y, *, metric, **kw):
        d = orig_lanes(self, x, y, metric=metric, **kw)
        return torch.full_like(d, float("inf")) if x.shape[1] == 1 else d
    monkeypatch.setattr(engine.TorchStatsBackend, "pairwise", pairwise)
    monkeypatch.setattr(engine.TorchStatsBackend, "pairwise_lanes",
                        pairwise_lanes)


def _half_batch(monkeypatch):
    """Every round's statistics over the first half of its batch, the
    mean taken over that half (weights doubled), the rest left out."""
    def halve(w):
        h = w.clone()
        h[h.shape[0] // 2:] = 0.0
        return h * 2.0
    for name, pos in (("build_stats", 4), ("swap_stats", 6),
                      ("build_stats_from_d", 3), ("swap_stats_from_d", 5)):
        orig = getattr(engine.TorchStatsBackend, name)

        def wrapped(self, *a, _orig=orig, _pos=pos, **kw):
            a = list(a)
            a[_pos - 1] = halve(a[_pos - 1])
            return _orig(self, *a, **kw)
        monkeypatch.setattr(engine.TorchStatsBackend, name, wrapped)


def _altered_label(monkeypatch):
    """The top-2 pass assigns row 0 to the next medoid slot."""
    orig = engine.TorchStatsBackend.top2

    def top2(self, x, med_pts, *, metric):
        d1, d2, a = orig(self, x, med_pts, metric=metric)
        a = a.clone()
        a[0] = (a[0] + 1) % med_pts.shape[0]
        return d1, d2, a
    monkeypatch.setattr(engine.TorchStatsBackend, "top2", top2)


def _altered_pick(monkeypatch):
    """Every fit's second BUILD search returns the arm after its pick (in
    a batch, lane 0's)."""
    from repro_torch.core import banditpam, batch
    orig, orig_lanes = banditpam.device_search, batch.lane_search

    def device_search(**kw):
        res = orig(**kw)
        if (kw.get("phase") == "build"
                and int(kw["active_init"].sum()) == kw["n_arms"] - 1):
            res = res._replace(best=(res.best + 1) % kw["n_arms"])
        return res

    def lane_search(**kw):
        res = orig_lanes(**kw)
        n0 = int(kw["n_ref"][0])
        if (kw.get("phase") == "build"
                and int(kw["active_init"][0].sum()) == n0 - 1):
            best = res.best.clone()
            best[0] = (best[0] + 1) % n0
            res = res._replace(best=best)
        return res
    monkeypatch.setattr(banditpam, "device_search", device_search)
    monkeypatch.setattr(batch, "lane_search", lane_search)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", [_stale_dnear, _half_batch,
                                   _altered_label, _altered_pick])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,n", [("scrna68k_l1_k5.fit", 2000),
                                        ("mnist70k_l2_k10.fit", 3000)])
def test_control_fails_the_limits(workload, n):
    bench = harness.Bench()
    limits = bench.limits(workload)
    for side in (False, True):
        nums = check.combine(readings(bench, workload, 777, side, "cpu",
                                      {"n": n}))
        verdict = check.passes(check.verdict(nums, limits))
        assert verdict is (not side), (side, nums, limits)


def test_batch_check_covers_every_lane_of_a_call(monkeypatch):
    """The batch cell checks each lane of one sampled call, so a fault in
    one lane slot is in every run's sample."""
    seen = []
    orig = check.judge_record

    def judge_record(rec, *a, **kw):
        seen.append(rec.seed)
        return orig(rec, *a, **kw)
    monkeypatch.setattr(check, "judge_record", judge_record)
    out, run = harness.run_cell(harness.Bench(), "scrna68k_l1_k5.batch",
                                2 ** 31 + 5, 0.5, False, time.perf_counter(),
                                device="cpu",
                                overrides=SMALL["scrna68k_l1_k5.batch"])
    assert out["correct"], out["checks"]
    lanes = [[f.seed for f in c.fits] for c in run.calls]
    assert len(lanes[0]) == 8 and seen in lanes


def test_setup_parts_sum_within_setup():
    out, run = harness.run_cell(harness.Bench(), "scrna68k_l1_k5.fit",
                                2 ** 31 + 6, 0.2, False, time.perf_counter(),
                                device="cpu",
                                overrides=SMALL["scrna68k_l1_k5.fit"])
    parts = out["setup_parts"]
    assert set(parts) == {"imports", "data", "warm_up"}
    assert 0 < sum(parts.values()) <= run.setup_s


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_walk_exact_space(metric):
    """A walk whose ``exact`` space is its own is the walk; the
    program-shaped control takes its losses and labels in float32."""
    from portbench import data
    from portbench.control import control_report
    from portbench.reference.bandit import Space, walk
    x, _ = data.scrna_like(400, seed=3, d=40)
    s64 = Space(x, metric, "float64", "cpu")
    a = walk(s64, 3, 11, batch_size=20)
    b = walk(s64, 3, 11, batch_size=20, exact=s64)
    assert a == b
    tf, f32 = (Space(x, metric, p, "cpu") for p in ("tf32", "float32"))
    rep, lab = control_report(tf, 3, 11, 20, "none", exact=f32)
    assert rep.loss == f32.loss(rep.medoids)
    assert (lab == torch.argmin(f32.to_medoids(rep.medoids), 1).numpy()).all()
