"""The port's device-resident fit driver (``fused=True``): rounds
enqueued without a read, each masked by the search's device flag once
the search has stopped, and the host reads it makes.

On the CPU the plain statistics run for a masked round too and the
search discards them, so these tests hold what the card's driver does
apart from the kernels' early return (``tests/test_torch_cuda.py``).
"""

import pytest

from repro.core import datasets as jdatasets
from repro_torch.core import BanditPAM, adaptive, banditpam, engine

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


def _search_rounds(monkeypatch):
    """Records (phase, rounds) of every search of a fit."""
    out = []
    orig = banditpam.device_search

    def spy(**kw):
        res = orig(**kw)
        out.append((kw["phase"], int(res.rounds)))
        return res
    monkeypatch.setattr(banditpam, "device_search", spy)
    return out


@pytest.mark.parametrize("every", [1, 7, 10 ** 6])
def test_rounds_past_the_stop_change_nothing(every, monkeypatch):
    """The report does not depend on how many rounds are enqueued between
    two reads.  With one read in 10**6 rounds every search enqueues all
    of its ceil(n/B) rounds, and those past its stop run masked.  The
    fixture's searches stop early (BUILD after 100, 100 and 84 of 100
    rounds), and the leader and the early stop keep state of their own
    to mask."""
    n, k, b = 400, 3, 4
    X = jdatasets.mnist_like(n, seed=2, d=32)
    kw = dict(device="cpu", seed=4, batch_size=b, baseline="leader",
              swap_early_stop=True)
    want = BanditPAM(k, fused=False, **kw).fit(X)
    monkeypatch.setattr(adaptive, "ROUNDS_PER_READ", every)
    calls = _count_rounds(monkeypatch)
    rounds = _search_rounds(monkeypatch)
    got = BanditPAM(k, fused=True, **kw).fit(X)
    assert _fields(got) == _fields(want)
    assert calls["all"] - calls["masked"] == sum(r for _, r in rounds)
    if every == 10 ** 6:
        assert calls["all"] == len(rounds) * -(-n // b)
    assert (calls["masked"] > 0) == (every > 1)


def test_fused_fit_reads_once_per_32_rounds(monkeypatch):
    """BUILD reads at most sum_i ceil(rounds_i / 32) + k + 1 times, fewer
    than the stepped driver; SWAP at most its searches' ceil(rounds / 32)
    plus two a iteration.  Replacement sampling keeps the stepped loop
    under either driver."""
    n, k, b = 650, 3, 10
    X = jdatasets.mnist_like(n, seed=1, d=32)
    rounds = _search_rounds(monkeypatch)
    per = adaptive.ROUNDS_PER_READ
    fused = BanditPAM(k, device="cpu", batch_size=b).fit(X)
    swaps = [r for ph, r in rounds if ph == "swap"]
    stepped = BanditPAM(k, device="cpu", batch_size=b, fused=False).fit(X)
    assert _fields(fused) == _fields(stepped)
    reads = fused.host_reads_by_phase
    assert max(fused.build_rounds) > per
    assert reads["build"] <= sum(-(-r // per)
                                 for r in fused.build_rounds) + k + 1
    assert reads["build"] < stepped.host_reads_by_phase["build"]
    assert len(swaps) == fused.n_swaps + int(fused.converged)
    assert reads["swap"] <= sum(-(-r // per) for r in swaps) + 2 * len(swaps)
    assert reads["swap"] < stepped.host_reads_by_phase["swap"]
    kw = dict(device="cpu", batch_size=50, sampling="replacement")
    a = BanditPAM(k, fused=True, **kw).fit(X)
    b_ = BanditPAM(k, fused=False, **kw).fit(X)
    assert a.host_reads_by_phase == b_.host_reads_by_phase
    assert _fields(a) == _fields(b_)
