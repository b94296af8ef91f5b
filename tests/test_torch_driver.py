"""The port's device-resident fit driver (``fused=True``): rounds
enqueued without a read, each masked by the search's device flag once
the search has stopped, and the host reads it makes.

On the CPU the plain statistics run for a masked round too and the
search discards them, so these tests hold what the card's driver does
apart from the kernels' early return (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro_torch.analysis.guard import expected_reads
from repro_torch.core import (BanditPAM, adaptive, banditpam, datasets,
                              engine, rng)
from torch_threads import one_intra_op_thread  # noqa: F401

REPORT = ("medoids", "swap_history", "build_rounds", "evals_by_phase",
          "swap_exact_fallbacks", "n_swaps", "converged", "loss")


def _fields(r):
    return {f: (getattr(r, f).tolist() if f == "medoids" else getattr(r, f))
            for f in REPORT}


def _count_rounds(monkeypatch):
    """Counts the stats calls of the torch backend, and those made with a
    run flag of 0 (rounds enqueued after their search stopped)."""
    calls = {"all": 0, "masked": 0}
    be = engine.TorchStatsBackend
    for name in ("build_stats", "swap_stats"):
        orig = getattr(be, name)

        def spy(self_, *a, _orig=orig, run=None, **kw):
            calls["all"] += 1
            calls["masked"] += int(run is not None and int(run) == 0)
            return _orig(self_, *a, run=run, **kw)
        monkeypatch.setattr(be, name, spy)
    return calls


def _count_ring_rounds(monkeypatch):
    """Counts the ring's accesses (one a PIC round), and those made with
    a run flag of 0 (rounds enqueued after their search stopped)."""
    calls = {"all": 0, "masked": 0}
    orig = banditpam.search_read_or_write

    def spy(*a, run, **kw):
        calls["all"] += 1
        calls["masked"] += int(int(run) == 0)
        return orig(*a, run=run, **kw)
    monkeypatch.setattr(banditpam, "search_read_or_write", spy)
    return calls


def _search_rounds(monkeypatch):
    """Records (phase, rounds run, rounds carried in) of every search of
    a fit."""
    out = []
    orig = banditpam.device_search

    def spy(**kw):
        res = orig(**kw)
        r0 = kw.get("init_rounds", 0) if "init_sums" in kw else 0
        out.append((kw["phase"], int(res.rounds) - r0, r0))
        return res
    monkeypatch.setattr(banditpam, "device_search", spy)
    return out


MASKED_MODES = {
    "leader+early_stop": dict(baseline="leader", swap_early_stop=True),
    # On mnist_like every replacement search runs its whole budget; on
    # blobs the third BUILD search stops after 2 of its 100 rounds.
    "replacement": dict(sampling="replacement", baseline="leader",
                        swap_early_stop=True),
    "pic": dict(reuse="pic", baseline="leader", swap_early_stop=True),
    # a ring of the whole permutation: carried repairs, no recycling
    "pic_full": dict(reuse="pic", cache_width=400, cache_cols=40),
}


@pytest.mark.parametrize("every,mode", [
    pytest.param(e, m, id=str(e) if m == "leader+early_stop" else f"{e}-{m}")
    for m in MASKED_MODES for e in (1, 7, 10 ** 6)])
def test_rounds_past_the_stop_change_nothing(every, mode, monkeypatch):
    """The report does not depend on how many rounds are enqueued between
    two reads.  With one read in 10**6 rounds every search enqueues all
    of its ceil(n/B) rounds, and those past its stop run masked.  The
    fixture's searches stop early (BUILD after 100, 100 and 84 of 100
    rounds), and the leader and the early stop keep state of their own
    to mask; so do replacement sampling (its exact fallback) and the PIC
    ring, whose bytes, ``hw`` and ``fresh_pos`` after the fit must be the
    stepped fit's (the default 32-round ring recycles; the full one runs
    the carried repair)."""
    n, k, b = 400, 3, 4
    X = (datasets.code_blobs(n, k, seed=4).astype(np.float32)
         if mode == "replacement" else jdatasets.mnist_like(n, seed=2, d=32))
    kw = dict(device="cpu", seed=4, batch_size=b, **MASKED_MODES[mode])
    want, want_ctx = BanditPAM(k, fused=False, **kw)._fit(X)
    monkeypatch.setattr(adaptive, "ROUNDS_PER_READ", every)
    pic = "reuse" in kw
    calls = (_count_ring_rounds if pic else _count_rounds)(monkeypatch)
    rounds = _search_rounds(monkeypatch)
    got, ctx = BanditPAM(k, fused=True, **kw)._fit(X)
    assert _fields(got) == _fields(want)
    assert calls["all"] - calls["masked"] == sum(r for _, r, _ in rounds)
    if every == 10 ** 6:
        assert calls["all"] == sum(-(-n // b) - r0 for _, _, r0 in rounds)
    assert (calls["masked"] > 0) == (every > 1)
    if pic:
        ring, stepped = ctx.cache, want_ctx.cache
        assert torch.equal(ring.cols, stepped.cols)
        assert (ring.hw, ring.fresh_pos) == (stepped.hw, stepped.fresh_pos)


def test_fused_fit_reads_once_per_32_rounds(monkeypatch):
    """BUILD reads at most sum_i ceil(rounds_i / 32) + k + 1 times, fewer
    than the stepped driver; SWAP at most its searches' ceil(rounds / 32)
    plus two a iteration, fewer than the stepped driver.  Replacement
    sampling, its exact fallback decided on the device, is held to the
    same bound (it read as often as the stepped driver until its fallback
    moved onto the device)."""
    for kw in ({}, {"sampling": "replacement"}):
        _check_read_bounds(kw, monkeypatch)
        monkeypatch.undo()


def test_fused_pic_fit_reads_once_per_32_rounds(monkeypatch):
    """The PIC ring's fused fit, whose BUILD searches read their round
    count with the flag (once more at the budget's end while the ring's
    window can still grow) and whose SWAP searches with the iteration's
    read, is held to the same bound, and reads fewer times than its
    stepped fit."""
    _check_read_bounds({"reuse": "pic"}, monkeypatch)


def _check_read_bounds(kw, monkeypatch):
    n, k, b = 650, 3, 10
    X = jdatasets.mnist_like(n, seed=1, d=32)
    rounds = _search_rounds(monkeypatch)
    per = adaptive.ROUNDS_PER_READ
    est = BanditPAM(k, device="cpu", batch_size=b, **kw)
    fused = est.fit(X)
    swaps = [r for ph, r, _ in rounds if ph == "swap"]
    stepped = BanditPAM(k, device="cpu", batch_size=b, fused=False,
                        **kw).fit(X)
    assert _fields(fused) == _fields(stepped)
    reads = fused.host_reads_by_phase
    assert max(fused.build_rounds) > per
    # The guard's read contract (analysis.guard.expected_reads), with the
    # SWAP searches' rounds: its formula, and the fit within it.
    bound = expected_reads(fused, est, n, swap_rounds=swaps)
    assert bound == {
        "build": sum(-(-r // per) for r in fused.build_rounds) + k + 1,
        "swap": sum(-(-r // per) for r in swaps) + 2 * len(swaps)}
    assert reads["build"] <= bound["build"]
    assert reads["build"] < stepped.host_reads_by_phase["build"]
    assert len(swaps) == fused.n_swaps + int(fused.converged)
    assert reads["swap"] <= bound["swap"]
    assert reads["swap"] <= expected_reads(fused, est, n)["swap"]
    assert reads["swap"] < stepped.host_reads_by_phase["swap"]


def test_generator_replacement_fit_keeps_the_stepped_loop():
    """Draws from one generator in consumption order
    (``rng.from_generator``) keep a replacement fit on the stepped loop
    under ``fused=True``, by the rule in ``BanditPAM._fit``: a round
    enqueued past a search's stop would use up the draws of the searches
    after it.  So the fused fit reads as often as the stepped one, once a
    round, and consumes the same draws: the same report, and the
    generator left in the same state."""
    n, k = 300, 3
    X = jdatasets.mnist_like(n, seed=3, d=32)
    kw = dict(device="cpu", batch_size=20, sampling="replacement",
              baseline="leader")
    srcs = {f: rng.from_generator(7, "cpu") for f in (True, False)}
    fits = {f: BanditPAM(k, fused=f, **kw).fit(X, layouts=srcs[f])
            for f in (True, False)}
    assert _fields(fits[True]) == _fields(fits[False])
    assert (fits[True].host_reads_by_phase
            == fits[False].host_reads_by_phase)
    assert (fits[True].host_reads_by_phase["build"]
            >= sum(fits[True].build_rounds))
    assert torch.equal(srcs[True].gen.get_state(),
                       srcs[False].gen.get_state())
    # The same seed's threefry draws run device-resident and read less.
    seeded = BanditPAM(k, fused=True, **kw).fit(X)
    assert (seeded.host_reads_by_phase["build"]
            < sum(seeded.build_rounds))
