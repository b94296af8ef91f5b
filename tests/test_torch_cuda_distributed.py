"""The sharded fit (``repro_torch.core.distributed``) on the card.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device.  Run on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_distributed.py``.

* World size 1 on ``nccl``: ``backend="cuda"`` against ``"torch"`` on
  ``code_blobs`` (integer l2sq distances, so both backends compute the
  same distances), both reuse modes: medoids, swaps, build rounds and
  fallbacks equal, the ledger within 0.1 % (the sharded fit always runs
  the leader, whose cross sums the kernels and the plain versions add in
  different orders: ROADMAP §C), one all-reduce a BUILD round enqueued
  (the device-resident default: at least one a round run, at most 31
  more a search), and the sharded path's kernels launched.
* World size 1 on ``nccl``, ``backend="cuda"``, both reuse modes: the
  device-resident fit (the default) against ``fused=False``: the same
  report bit for bit, fewer reads, the stepped fit one all-reduce a BUILD
  round run; and one resident fit under
  ``torch.cuda.set_sync_debug_mode("error")``, where only
  ``engine.host_read`` may sync (it lifts the mode around its copy).
* Two ``gloo`` ranks spawned on the one card (the resident default):
  every rank's report identical, loss bits included, and within the
  same allowance of the two-rank ``"torch"`` fit.

NCCL puts one rank on a device, so several ranks on one card go through
``gloo``, whose ``all_reduce`` takes CUDA tensors.  Every group has a
timeout and is destroyed at the end.
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from repro_torch.api import KMedoids
from repro_torch.core import adaptive, datasets
from repro_torch.core import distributed as tdist
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

TIMEOUT = 600


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def nccl1(cuda):
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=TIMEOUT))
    yield dist.group.WORLD
    dist.destroy_process_group()


def _allreduces_in_bounds(ar, build_rounds, k):
    """One all-reduce a BUILD round enqueued: at least one a round run, at
    most ROUNDS_PER_READ − 1 more a search."""
    per = adaptive.ROUNDS_PER_READ
    return (sum(build_rounds) <= ar["build"]
            <= sum(build_rounds) + (per - 1) * k)


def _same_fit(a, b, rtol=1e-3):
    assert a.medoids.tolist() == b.medoids.tolist()
    assert ([h[:2] for h in a.swap_history]
            == [h[:2] for h in b.swap_history])
    assert a.build_rounds == b.build_rounds
    assert (a.n_swaps, a.converged, a.swap_exact_fallbacks) == (
        b.n_swaps, b.converged, b.swap_exact_fallbacks)
    assert a.evals_by_phase.keys() == b.evals_by_phase.keys()
    for ph, v in b.evals_by_phase.items():
        assert abs(a.evals_by_phase[ph] - v) <= rtol * v, (ph, a, b)
    assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_world1_nccl_cuda_matches_torch(reuse, nccl1):
    X = datasets.code_blobs(3000, 10, seed=1)
    fits = {}
    for be in ("cuda", "torch"):
        ops.reset_launch_counts()
        tdist.reset_allreduce_counts()
        fits[be] = KMedoids(10, solver="banditpam_dist", metric="l2", seed=0,
                            backend=be, reuse=reuse).fit(X).report_
        counts, ar = ops.launch_counts(), tdist.allreduce_counts()
        assert _allreduces_in_bounds(ar, fits[be].build_rounds, 10)
        if be == "cuda":
            assert min(counts[nm] for nm in
                       ("pairwise", "swap_g_from_cache", "top2")) >= 1
        else:
            assert sum(counts.values()) == 0
    _same_fit(fits["cuda"], fits["torch"])


REPORT = ("swap_history", "build_rounds", "evals_by_phase",
          "swap_exact_fallbacks", "n_swaps", "converged", "loss")


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_world1_nccl_resident_matches_stepped(reuse, nccl1):
    """The device-resident fit and the stepped fit on the card: identical
    reports (loss bits included), the resident fit reading fewer times
    in each phase; all-reduces one a round run (stepped) or enqueued
    (resident, within its bounds)."""
    X = datasets.mnist_like(6000, seed=0)
    fits, ars = {}, {}
    for fused in (True, False):
        tdist.reset_allreduce_counts()
        fits[fused] = KMedoids(10, solver="banditpam_dist", metric="l2",
                               seed=0, backend="cuda", reuse=reuse,
                               fused=fused).fit(X).report_
        ars[fused] = tdist.allreduce_counts()
    a, b = fits[True], fits[False]
    assert a.medoids.tolist() == b.medoids.tolist()
    for f in REPORT:
        assert getattr(a, f) == getattr(b, f), f
    for ph in ("build", "swap"):
        assert a.host_reads_by_phase[ph] < b.host_reads_by_phase[ph]
    assert ars[False]["build"] == sum(b.build_rounds)
    assert _allreduces_in_bounds(ars[True], a.build_rounds, 10)


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_resident_fit_syncs_only_to_read(reuse, nccl1):
    """A resident fit on data already on the card, under
    ``set_sync_debug_mode("error")``: any sync but ``engine.host_read``'s
    (and the phase walls', which lift the mode too) raises.  A first fit
    loads the kernels and starts the communicator."""
    X = torch.as_tensor(datasets.mnist_like(3000, seed=1),
                        device="cuda")
    kw = dict(metric="l2", seed=0, backend="cuda", reuse=reuse)
    want = tdist.DistributedBanditPAM(10, **kw).fit(X)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tdist.DistributedBanditPAM(10, **kw).fit(X)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.medoids.tolist() == want.medoids.tolist()
    for f in REPORT:
        assert getattr(got, f) == getattr(want, f), f


def test_two_gloo_ranks_on_the_card(cuda):
    X = datasets.code_blobs(2000, 10, seed=2)
    cases = [(X, 10, {"backend": be, "reuse": r})
             for r in ("none", "pic") for be in ("cuda", "torch")]
    out = tdist.spawn_fits(cases, 2, device="cuda", timeout=TIMEOUT)
    for ranks in out:
        a, b = ranks[0].report, ranks[1].report
        assert a.medoids.tolist() == b.medoids.tolist()
        for f in ("swap_history", "build_rounds", "evals_by_phase", "loss",
                  "n_swaps", "converged", "swap_exact_fallbacks",
                  "host_reads_by_phase"):
            assert getattr(a, f) == getattr(b, f), f
        assert ranks[0].allreduces == ranks[1].allreduces
    for i in (0, 2):
        _same_fit(out[i][0].report, out[i + 1][0].report)
