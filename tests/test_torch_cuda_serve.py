"""The serving layer on the card: a ``"cuda"`` ``MedoidService`` against
a ``"torch"`` one on the card, warm-started fits, snapshot and resume,
and the reservoir's draws.

Marked ``gpu``; the ``cuda`` fixture skips every test where there is no
CUDA device (decided inside the fixture, never at import).  Run on the
card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_serve.py``.

The services run on ``datasets.code_blobs``, integer points whose l2
distances both backends compute exactly, so the kernels and the plain
versions see the same distances: the refits trip at the same chunks and
land on the same medoids, labels and nearest distances are equal bit for
bit, and the ledgers agree within the allowance ``chip_smoke.py`` phase
4 gives the cache modes, 2·n·B per entry (a kill on an exact float32
margin can end a search a round later: ROADMAP §C).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BanditPAM, datasets, threefry
from repro_torch.kernels import ops
from repro_torch.serve import MedoidService
from repro_torch.serve.reservoir import stream_uniforms

pytestmark = pytest.mark.gpu

K, N, B = 10, 4000, 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fit_rows():
    return datasets.code_blobs(N, K, seed=6)


def _stream():
    # Blobs around other centres: the monitor trips.
    return datasets.code_blobs(N, K, seed=7)


def _ledgers_close(a, b, n):
    assert a.evals_by_phase.keys() == b.evals_by_phase.keys()
    assert all(abs(v - b.evals_by_phase[p]) <= 2 * n * B
               for p, v in a.evals_by_phase.items())


def _serve(svc, stream, step=500):
    """Ingest ``stream``; returns (labels, dmin, refit positions,
    refit reports)."""
    labels, dmin, trips, reports = [], [], [], []
    for lo in range(0, len(stream), step):
        r = svc.ingest(stream[lo:lo + step])
        labels.append(r.labels)
        dmin.append(r.dmin)
        if r.refit is not None:
            trips.append(lo)
            reports.append(r.refit)
    return np.concatenate(labels), np.concatenate(dmin), trips, reports


@pytest.mark.parametrize("kw,kernels", [
    ({}, ("top2", "pairwise", "swap_g_from_cache")),
    ({"solver": "banditpam", "refit_params": {"reuse": "none"}},
     ("top2", "build_g", "swap_g")),
])
def test_cuda_service_matches_torch(cuda, kw, kernels):
    """The defaults (BanditPAM++ fit, warm PIC refits) and a plain
    BanditPAM fit with ``reuse="none"`` warm refits, which put build_g
    and swap_g on the serving path."""
    out = {}
    for be in ("cuda", "torch"):
        ops.reset_launch_counts()
        svc = MedoidService(K, "l2", backend=be, device=cuda, **kw)
        svc.fit(_fit_rows())
        out[be] = (svc, *_serve(svc, _stream()), ops.launch_counts())
    (a, la, da, ta, ra, counts), (b, lb, db, tb, rb, plain) = (
        out["cuda"], out["torch"])
    assert ta and ta == tb
    np.testing.assert_array_equal(la, lb)
    assert da.tobytes() == db.tobytes()
    for x, y in zip(ra, rb):
        assert x.medoids.tolist() == y.medoids.tolist()
        assert x.evals_by_phase["build"] == 0
        _ledgers_close(x, y, K + len(a.reservoir))
    assert a.medoid_points.cpu().numpy().tobytes() == \
        b.medoid_points.cpu().numpy().tobytes()
    assert np.array_equal(a.reservoir.sidx, b.reservoir.sidx)
    assert min(counts[nm] for nm in kernels) >= 1, counts
    assert not any(plain.values()), plain


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_warm_start_fit_cuda_matches_torch(cuda, reuse):
    X = torch.from_numpy(datasets.code_blobs(2048, 8, seed=19)).to(cuda)
    kw = {"reuse": reuse}
    if reuse == "pic":
        kw["cache_width"] = 10 * B           # half of the 21 rounds: recycles
    ws = np.arange(8) * 97 + 3
    fits = {be: BanditPAM(8, seed=4, backend=be, device=cuda, **kw).fit(
        X, warm_start=ws) for be in ("cuda", "torch")}
    a, b = fits["cuda"], fits["torch"]
    assert a.medoids.tolist() == b.medoids.tolist()
    assert [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
    assert a.evals_by_phase["build"] == 0 and a.n_swaps > 0
    _ledgers_close(a, b, 2048)
    assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)


def test_snapshot_on_the_card_resumes_bit_identical(cuda, tmp_path):
    svc = MedoidService(K, "l2", device=cuda).fit(_fit_rows())
    stream = _stream()
    _serve(svc, stream[:1500])
    svc.snapshot(str(tmp_path))
    back = MedoidService.restore(str(tmp_path), device=cuda)
    assert back.medoid_points.device.type == cuda.type
    assert back.stats() == svc.stats()
    # The rest of the stream, then blobs around a third set of centres.
    rest = np.concatenate([stream[1500:], datasets.code_blobs(2000, K,
                                                              seed=8)])
    la, da, ta, _ = _serve(svc, rest)
    lb, db, tb, _ = _serve(back, rest)
    assert ta and ta == tb
    np.testing.assert_array_equal(la, lb)
    assert da.tobytes() == db.tobytes()
    assert back.stats() == svc.stats()
    assert back.medoid_points.cpu().numpy().tobytes() == \
        svc.medoid_points.cpu().numpy().tobytes()
    for key, v in svc.reservoir.state().items():
        assert np.asarray(back.reservoir.state()[key]).tobytes() == \
            np.asarray(v).tobytes()


def test_reservoir_uniforms_card_equal_cpu(cuda):
    idx = np.concatenate([np.arange(60000), 2 ** 31 - 5 + np.arange(10),
                          2 ** 32 - 5 + np.arange(10)]).astype(np.int64)
    for seed in (0, 2 ** 31 + 7):
        key = threefry.PRNGKey(seed)
        got = threefry.uniform(threefry.fold_in(
            key, torch.as_tensor(idx, device=cuda)))
        assert got.is_cuda
        assert torch.equal(got.cpu(), stream_uniforms(key, idx))
