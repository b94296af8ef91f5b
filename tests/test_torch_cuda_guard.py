"""The runtime guard and the peak-memory budgets on the card.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device.  Run on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_guard.py``.

* The guard catches a sync: an ``.item()`` injected into a fit's BUILD
  round raises under ``guarded``; ``engine.host_read`` and
  ``engine.host_stage`` do not.
* ``FitGuard`` over every device-resident driver at 3,000 rows of
  ``mnist_like`` (d = 784, k = 10, l2, ``backend="cuda"``), the data
  given as numpy so that the upload goes through its ``host_stage``:
  the default fit, replacement sampling with the leader, the PIC ring, a
  warm start, ``fit_batch`` in both reuse modes, and the sharded fit at
  world size 1 on ``nccl`` in both reuse modes.  Each guarded fit equals
  its warm-up and reads within ``expected_reads``.
* Every budget key measured on the card at its canonical shapes: the
  entry point under its bound, its materialised form over it.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import budgets
from repro_torch.analysis.guard import (FitGuard, expected_reads,  # noqa: F401
                                        guarded, sync_guard,
                                        torch_fit_guard)
from repro_torch.core import BanditPAM, datasets, engine
from repro_torch.core import distributed as tdist

pytestmark = pytest.mark.gpu

N, K = 3000, 10
MODES = {
    "permutation": {},
    "replacement+leader": {"sampling": "replacement", "baseline": "leader"},
    "pic": {"reuse": "pic"},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    return datasets.mnist_like(N, seed=1)


def _est(**kw):
    return BanditPAM(K, metric="l2", seed=0, backend="cuda", **kw)


def test_guard_catches_an_injected_sync(cuda, data, monkeypatch):
    """The twin of the JAX guard's own test: a BUILD round that reads a
    value with ``.item()`` raises under the guard (and not without)."""
    x = torch.as_tensor(data, device=cuda)
    _est().fit(x)
    orig = engine.CudaStatsBackend.build_stats

    def reads(self, data, ref_idx, *a, **kw):
        ref_idx[0].item()
        return orig(self, data, ref_idx, *a, **kw)
    monkeypatch.setattr(engine.CudaStatsBackend, "build_stats", reads)
    _est().fit(x)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with guarded(cuda):
            _est().fit(x)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_host_read_and_host_stage_are_sanctioned(cuda, sync_guard):
    t = torch.arange(4, device=cuda)
    with sync_guard(cuda):
        assert engine.host_read([t.sum()]) == [6]
        with engine.host_stage("test staging"):
            u = torch.as_tensor(np.arange(3)).to(cuda)
        with pytest.raises(RuntimeError, match="synchroniz"):
            t.sum().item()
    assert engine.host_read([u]) == [[0, 1, 2]]


@pytest.mark.parametrize("mode", list(MODES))
def test_guarded_fit(mode, cuda, data, torch_fit_guard):
    est = _est(**MODES[mode])
    got = torch_fit_guard.fit(est, data)
    assert min(torch_fit_guard.last_launches.values()) >= 1
    bound = expected_reads(got, est, N)
    assert all(v <= bound[ph] for ph, v in got.host_reads_by_phase.items())


def test_guarded_warm_start(cuda, data, torch_fit_guard):
    est = _est(reuse="pic")
    cold = est.fit(data)
    got = torch_fit_guard.fit(est, data, warm_start=cold.medoids)
    assert "build" not in got.host_reads_by_phase
    assert got.medoids.tolist() == cold.medoids.tolist()


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_guarded_fit_batch(reuse, cuda, data, torch_fit_guard):
    lanes = [data[:2000], data[:1500], data]
    batch = torch_fit_guard.fit_batch(_est(reuse=reuse), lanes,
                                      seeds=[0, 1, 2])
    assert batch.dispatches_by_phase["build"] > 0


@pytest.fixture
def nccl1(cuda):
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=600))
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_guarded_sharded_fit(reuse, data, nccl1, torch_fit_guard):
    est = tdist.DistributedBanditPAM(K, metric="l2", seed=0, backend="cuda",
                                     reuse=reuse)
    got = torch_fit_guard.fit(est, data)
    bound = expected_reads(got, est, N)
    assert all(v <= bound[ph] for ph, v in got.host_reads_by_phase.items())


@pytest.mark.parametrize("name", budgets.budget_names())
def test_budget_measured_on_the_card(name, cuda):
    m = budgets.measure(name, device=cuda)
    assert 0 <= m.temp <= m.bound, (m, budgets.budget_doc(name))
    assert m.materialised > m.bound, (m, budgets.materialised_doc(name))
