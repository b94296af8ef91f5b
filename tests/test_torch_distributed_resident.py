"""The sharded fit's device-resident loop (``DistributedBanditPAM``,
``fused=True``, the default) against its stepped loop (``fused=False``)
on a one-rank ``gloo`` group in this process.

Rounds are enqueued without a read and masked on the device once their
search has stopped; every enqueued round makes its all-reduce.  On the
CPU the plain statistics run for a masked round too and the search
discards them, so these tests hold what the card's driver does apart from
the kernels' early return.  The two and four rank cases run with the
JAX comparisons' ranks (``tests/test_torch_distributed.py``).

``mnist_like(400, seed=1, d=32)``, k = 3, B = 4 (100 rounds a search):
searches stop early (the replacement fit's first BUILD search after 25
rounds, the PIC fits' BUILD searches after 98, 100 and 81 and their
first SWAP search after 94), the replacement fit resolves SWAP searches
by its exact fallback, the default 32-round ring recycles, and the full
ring runs the carried repair after each of its three swaps.
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from repro.core import datasets as jdatasets
from repro_torch.core import adaptive
from repro_torch.core import distributed as tdist
from torch_threads import one_intra_op_thread  # noqa: F401

N, K, B = 400, 3, 4
TIMEOUT = 120
REPORT = ("medoids", "swap_history", "build_rounds", "evals_by_phase",
          "swap_exact_fallbacks", "n_swaps", "converged", "loss")
MODES = {
    "none": {},
    "pic": {"reuse": "pic"},                        # 32 rounds: recycles
    "pic_full": {"reuse": "pic", "cache_width": N},   # carried repairs
}


@pytest.fixture()
def world1():
    """A one-rank ``gloo`` group in this process (the default group)."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=TIMEOUT))
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def data():
    return jdatasets.mnist_like(N, seed=1, d=32)


def _fields(r):
    return {f: (getattr(r, f).tolist() if f == "medoids" else getattr(r, f))
            for f in REPORT}


def _search_rounds(monkeypatch):
    """Records (phase, rounds run, rounds carried in) of every search."""
    out = []
    orig = tdist.device_search

    def spy(**kw):
        res = orig(**kw)
        r0 = kw.get("init_rounds", 0) if "init_sums" in kw else 0
        out.append((kw["phase"], int(res.rounds) - r0, r0))
        return res
    monkeypatch.setattr(tdist, "device_search", spy)
    return out


def _fit(X, fused, mode):
    """One fit on the default group: its report, its state and its
    all-reduces by phase."""
    tdist.reset_allreduce_counts()
    rep, state = tdist.DistributedBanditPAM(
        K, batch_size=B, device="cpu", fused=fused, **MODES[mode])._fit(X)
    return rep, state, tdist.allreduce_counts()


@pytest.mark.parametrize("every", [1, 7, 10 ** 6])
@pytest.mark.parametrize("mode", list(MODES))
def test_rounds_past_the_stop_change_nothing(every, mode, data, world1,
                                             monkeypatch):
    """The report does not depend on how many rounds are enqueued between
    two reads.  With one read in 10**6 rounds every search enqueues all of
    its rounds to the budget, each with its all-reduce, and those past its
    stop run masked; the rank's PIC ring (bytes, ``hw``, ``fresh_pos``)
    ends as the stepped fit's."""
    want, want_state, want_ar = _fit(data, False, mode)
    monkeypatch.setattr(adaptive, "ROUNDS_PER_READ", every)
    rounds = _search_rounds(monkeypatch)
    got, state, ar = _fit(data, True, mode)
    assert _fields(got) == _fields(want)
    ran = {ph: sum(r for p, r, _ in rounds if p == ph)
           for ph in ("build", "swap")}
    repairs = want_ar["swap"] - ran["swap"]     # one a carried repair
    assert repairs == (3 if mode == "pic_full" else 0)
    assert want_ar["build"] == ran["build"] == sum(got.build_rounds)
    masked = {ph: ar[ph] - want_ar[ph] for ph in ("build", "swap")}
    assert (masked["build"] > 0) == (every > 1)
    if every == 10 ** 6:
        budget = -(-N // B)
        assert ar["build"] == K * budget
        assert ar["swap"] == sum(budget - r0 for p, _, r0 in rounds
                                 if p == "swap") + repairs
    if "reuse" in MODES[mode]:
        ring, stepped = state.ring, want_state.ring
        assert torch.equal(ring.cols, stepped.cols)
        assert (ring.hw, ring.fresh_pos) == (stepped.hw, stepped.fresh_pos)


@pytest.mark.parametrize("mode", list(MODES))
def test_reads_and_allreduces_within_their_bounds(mode, data, world1,
                                                  monkeypatch):
    """At the default read interval: BUILD reads at most
    Σ_i ceil(rounds_i / 32) + k + 1 times, SWAP at most its searches'
    ceil(rounds / 32) plus two an iteration, each fewer than the stepped
    fit.  All-reduces: the stepped fit makes one a round run (plus one a
    carried repair); the resident fit makes one a round enqueued, so at
    least as many and at most 31 more a search."""
    per = adaptive.ROUNDS_PER_READ
    stepped, _, s_ar = _fit(data, False, mode)
    rounds = _search_rounds(monkeypatch)
    got, _, ar = _fit(data, True, mode)
    assert _fields(got) == _fields(stepped)
    swaps = [r for p, r, _ in rounds if p == "swap"]
    assert len(swaps) == got.n_swaps + int(got.converged)
    reads, s_reads = got.host_reads_by_phase, stepped.host_reads_by_phase
    assert max(got.build_rounds) > per
    assert reads["build"] <= sum(-(-r // per)
                                 for r in got.build_rounds) + K + 1
    assert reads["swap"] <= sum(-(-r // per) for r in swaps) + 2 * len(swaps)
    assert reads["build"] < s_reads["build"]
    assert reads["swap"] < s_reads["swap"]
    repairs = s_ar["swap"] - sum(swaps)
    assert s_ar["build"] == sum(got.build_rounds)
    assert (sum(got.build_rounds) <= ar["build"]
            <= sum(got.build_rounds) + (per - 1) * K)
    assert (sum(swaps) + repairs <= ar["swap"]
            <= sum(swaps) + repairs + (per - 1) * len(swaps))


def test_facade_passes_the_switch(data, world1):
    """``KMedoids(solver="banditpam_dist", fused=False)`` reaches the
    sharded fit: the same report as the default, one read a round."""
    from repro_torch.api import KMedoids
    fits = {f: KMedoids(K, solver="banditpam_dist", device="cpu",
                        batch_size=B, fused=f).fit(data).report_
            for f in (True, False)}
    assert _fields(fits[True]) == _fields(fits[False])
    assert (fits[False].host_reads_by_phase["build"]
            == sum(fits[False].build_rounds) + K + 1)
    assert (fits[True].host_reads_by_phase["build"]
            < sum(fits[True].build_rounds))
