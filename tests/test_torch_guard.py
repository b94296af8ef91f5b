"""The port's runtime guard (``repro_torch.analysis.guard``) on the CPU.

``FitGuard`` runs a warm-up fit, then the same fit under the guard, and
holds the guarded fit to its warm-up (report, launches, kernel state)
and to the read contract of the device-resident loop
(``expected_reads``).  On the CPU the sync debug mode has nothing to
catch (``guarded`` does nothing there; the card's tests are
``tests/test_torch_cuda_guard.py``); everything else runs:

* a guarded fit in each resident mode (permutation, replacement with the
  leader, the PIC ring, a warm start), the batch in both reuse modes and
  the sharded fit at world size 1 on ``gloo``;
* the guarded port fit against the JAX package's own ``FitGuard`` fit
  on the same input and seed, in both reuse modes: medoids, swap history
  and ledger equal, the loss to rtol 1e-5;
* the guard's own checks catch a report that moved and reads past the
  contract; the stepped driver and an empty staging reason raise.
"""

import datetime
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis.guard import FitGuard as JFitGuard
from repro.core.banditpam import BanditPAM as JBanditPAM
from repro.core import datasets as jdatasets
from repro_torch.analysis import guard
from repro_torch.analysis.guard import (FitGuard, expected_reads,  # noqa: F401
                                        sync_guard, torch_fit_guard)
from repro_torch.core import BanditPAM, engine
from repro_torch.core import distributed as tdist
from repro_torch.core.report import FitReport
from torch_threads import one_intra_op_thread  # noqa: F401

N, K, B = 400, 3, 20
MODES = {
    "permutation": {},
    "replacement+leader": {"sampling": "replacement", "baseline": "leader"},
    "pic": {"reuse": "pic"},
}


@pytest.fixture(scope="module")
def data():
    return jdatasets.mnist_like(N, seed=1, d=32)


def _fields(r):
    return (r.medoids.tolist(), r.loss, r.evals_by_phase, r.swap_history,
            r.build_rounds, r.host_reads_by_phase)


@pytest.mark.parametrize("mode", list(MODES))
def test_guarded_fit_equals_its_warmup(mode, data, torch_fit_guard):
    est = BanditPAM(K, device="cpu", batch_size=B, **MODES[mode])
    got = torch_fit_guard.fit(est, data)
    again = BanditPAM(K, device="cpu", batch_size=B,
                      **MODES[mode]).fit(data)
    assert _fields(got) == _fields(again)
    bound = expected_reads(got, est, N)
    assert set(got.host_reads_by_phase) == {"build", "swap"}
    for ph, v in got.host_reads_by_phase.items():
        assert 0 < v <= bound[ph]


def test_guarded_warm_start(data, torch_fit_guard):
    est = BanditPAM(K, device="cpu", batch_size=B, reuse="pic")
    cold = est.fit(data)
    got = torch_fit_guard.fit(est, data, warm_start=cold.medoids)
    assert got.evals_by_phase["build"] == 0
    assert "build" not in got.host_reads_by_phase
    assert "build" not in expected_reads(got, est, N)
    assert got.medoids.tolist() == cold.medoids.tolist()


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_guarded_fit_matches_the_jax_guard(reuse, data, torch_fit_guard):
    """The same input and seed through both packages' guards: the JAX
    fit under ``transfer_guard("disallow")`` with its dispatch contract,
    the port's under the read contract."""
    want = JFitGuard().fit(JBanditPAM(K, seed=0, reuse=reuse,
                                      backend="jnp"), data)
    got = torch_fit_guard.fit(BanditPAM(K, seed=0, reuse=reuse,
                                        device="cpu"), data)
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    assert got.build_rounds == want.build_rounds
    assert got.evals_by_phase == want.evals_by_phase
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
    for (_, _, lg), (_, _, lw) in zip(got.swap_history, want.swap_history):
        assert abs(lg - lw) <= 1e-5 * abs(lw)


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_guarded_fit_batch(reuse, data, torch_fit_guard):
    est = BanditPAM(K, device="cpu", batch_size=B, reuse=reuse)
    lanes = [data[:300], data[:217], data]
    batch = torch_fit_guard.fit_batch(est, lanes, seeds=[0, 1, 2])
    solo = BanditPAM(K, device="cpu", batch_size=B, reuse=reuse,
                     seed=1).fit(data[:217])
    assert batch[1].medoids.tolist() == solo.medoids.tolist()
    assert batch[1].loss == solo.loss
    assert batch.dispatches_by_phase["build"] > 0


@pytest.fixture()
def world1():
    """A one-rank ``gloo`` group in this process (the default group)."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_guarded_sharded_fit_on_gloo(reuse, data, world1, torch_fit_guard):
    tdist.reset_allreduce_counts()
    est = tdist.DistributedBanditPAM(K, device="cpu", batch_size=B,
                                     reuse=reuse)
    got = torch_fit_guard.fit(est, data)
    assert est.n_shards == 1 and tdist.allreduce_counts()["build"] > 0
    bound = expected_reads(got, est, N)
    assert all(v <= bound[ph] for ph, v in got.host_reads_by_phase.items())


def test_stepped_driver_and_empty_reason_raise(data):
    g = FitGuard()
    with pytest.raises(ValueError, match="fused=True"):
        g.fit(BanditPAM(K, device="cpu", fused=False), data)
    with pytest.raises(ValueError, match="fused=True"):
        g.fit_batch(BanditPAM(K, device="cpu", fused=False), [data])
    with pytest.raises(ValueError, match="reason"):
        with engine.host_stage(""):
            pass
    with engine.host_stage("a reason"):
        pass
    assert guard.host_stage is engine.host_stage
    assert guard.host_read is engine.host_read


class _Replay:
    """An estimator whose fits return the given reports in turn."""
    fused, device, batch_size, k = True, "cpu", 100, 2

    def __init__(self, *reports):
        self.reports = list(reports)

    def fit(self, data):
        return self.reports.pop(0)


def _report(loss=1.0, build=2, swap=3):
    return FitReport(medoids=np.array([0, 1]), loss=loss, n_swaps=1,
                     converged=True, build_rounds=[3, 4],
                     host_reads_by_phase={"build": build, "swap": swap})


def test_fit_guard_catches_what_moved(data):
    """The guard's own checks: a loss that moved, and reads past the
    contract (k + 1 + one a search's round block in BUILD; two
    iterations of ceil(ceil(n / B) / 32) + 2 in SWAP)."""
    with pytest.raises(AssertionError, match="loss"):
        FitGuard().fit(_Replay(_report(), _report(loss=2.0)), data)
    bound = expected_reads(_report(), _Replay(), N)
    assert bound == {"build": 2 + 2 + 1, "swap": 2 * (1 + 2)}
    assert FitGuard().fit(_Replay(_report(build=5, swap=6)), data,
                          warmup=False).loss == 1.0
    for reads in ({"build": 6}, {"swap": 7}, {"stream": 1}):
        rep = _report()
        rep.host_reads_by_phase.update(reads)
        with pytest.raises(AssertionError, match="contract"):
            FitGuard().fit(_Replay(rep), data, warmup=False)


def test_guarded_does_nothing_on_the_cpu(sync_guard):
    with sync_guard("cpu"):
        assert float(torch.ones(2).sum()) == 2.0


def test_driver_read_bound_is_expected_reads():
    """``tests/test_torch_driver.py``'s read bound is this function: its
    helper ``_check_read_bounds`` calls it."""
    import test_torch_driver as drv
    assert drv.expected_reads is guard.expected_reads
    assert "expected_reads(" in inspect.getsource(drv._check_read_bounds)
