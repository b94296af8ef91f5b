"""The rest of Algorithm 1 in the port — replacement sampling with its
exact fallback, the leader baseline, the SWAP early stop and the stepped
loop — held against the JAX package on the CPU.

The JAX chain's draws are injected through the layout seam: permutations
for ``sampling="permutation"``, per-round batches for
``sampling="replacement"`` (``repro_torch.convert``).  Medoids, swap
history, ``evals_by_phase``, ``build_rounds`` and
``swap_exact_fallbacks`` must be equal; the loss agrees to rtol 1e-5.

One exception, ``baseline="leader"`` under permutation sampling: there
each phase's ledger is held to within 4 arm-rounds (4·B evaluations) of
the JAX fit's, the rest exactly.  The differenced kill rule's σ comes
from ``Σg² − 2·Σg·g_lead + Σg_lead²`` over one batch, a difference of
sums whose float32 rounding depends on the summation order, so an arm
whose differenced margin sits within that noise of the ``LEAD_TIE_REL``
threshold dies a round earlier or later.  ``test_torch_leader.py`` holds
the parts exactly: the port's search pays the JAX search's ledger
exactly on bit-identical statistics, the cross-sums agree to float32
rounding, and the JAX package's own jitted and op-by-op fits pay
different BUILD ledgers at (650, 5, l2).
"""

import numpy as np
import pytest
import torch

from repro.core import BanditPAM as JBanditPAM
from repro.core import datasets as jdatasets
from repro_torch import convert
from repro_torch.core import BanditPAM, engine, rng
from test_torch_banditpam import FIXTURES, jax_draws, jax_layouts
from torch_threads import one_intra_op_thread  # noqa: F401

MODES = {
    "replacement": {"sampling": "replacement"},
    "leader": {"baseline": "leader"},
    "replacement+leader": {"sampling": "replacement", "baseline": "leader"},
    "early_stop": {"swap_early_stop": True},
    "replacement+early_stop": {"sampling": "replacement",
                               "swap_early_stop": True},
}


def _layouts(kw, n, k):
    if kw.get("sampling") == "replacement":
        return convert.draws_from_reference(*jax_draws(0, n, k))
    return convert.layouts_from_reference(*jax_layouts(0, n, k))


class _Spy:
    """Counts the exact passes of the torch backend."""

    def __init__(self, monkeypatch):
        self.calls = {"build": 0, "swap": 0}
        be = engine.TorchStatsBackend
        for phase in ("build", "swap"):
            orig = getattr(be, f"stream_{phase}_sums")

            def spy(self_, *a, _orig=orig, _phase=phase, **kw):
                self.calls[_phase] += 1
                return _orig(self_, *a, **kw)
            monkeypatch.setattr(be, f"stream_{phase}_sums", spy)


def check_mode_against_jax(n, k, metric, mode, monkeypatch):
    kw = MODES[mode]
    X = jdatasets.mnist_like(n, seed=1)
    want = JBanditPAM(k, metric=metric, seed=0, backend="jnp", **kw).fit(X)
    spy = _Spy(monkeypatch)
    got = BanditPAM(k, metric=metric, device="cpu", **kw).fit(
        X, layouts=_layouts(kw, n, k))
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    assert got.build_rounds == want.build_rounds
    assert got.swap_exact_fallbacks == want.swap_exact_fallbacks
    assert (got.n_swaps, got.converged) == (want.n_swaps, want.converged)
    if mode == "leader":
        assert got.evals_by_phase.keys() == want.evals_by_phase.keys()
        for ph, v in want.evals_by_phase.items():
            assert abs(got.evals_by_phase[ph] - v) <= 4 * 100, ph
    else:
        assert got.evals_by_phase == want.evals_by_phase
        assert got.distance_evals == want.distance_evals
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
    # The exact passes ran exactly when the JAX fit fell back: every SWAP
    # fallback is one stream_swap_sums call, and under replacement
    # sampling these small fits exhaust the BUILD budget too.
    assert spy.calls["swap"] == want.swap_exact_fallbacks
    if kw.get("sampling") == "replacement":
        assert want.swap_exact_fallbacks >= 1
        assert spy.calls["build"] >= 1
    else:
        assert spy.calls == {"build": 0, "swap": 0}


# The l1 fixture runs in tests/test_torch_sampling_l1.py, so that the two
# halves of the matrix land on different test workers.
@pytest.mark.parametrize("n,k,metric,mode",
                         [f + (m,) for f in FIXTURES if f[2] == "l2"
                          for m in MODES if m != "replacement+early_stop"]
                         + [(300, 3, "l2", "replacement+early_stop")])
def test_fit_modes_match_jax_reference(n, k, metric, mode, monkeypatch):
    check_mode_against_jax(n, k, metric, mode, monkeypatch)


@pytest.mark.parametrize("kw", [{}, {"baseline": "leader"},
                                {"swap_early_stop": True},
                                {"cache_cols": 200},
                                {"sampling": "replacement",
                                 "baseline": "leader",
                                 "swap_early_stop": True},
                                {"sampling": "replacement"},
                                {"reuse": "pic"},
                                {"reuse": "pic", "cache_width": 40},
                                {"reuse": "pic", "cache_width": 200,
                                 "cache_cols": 400},
                                {"reuse": "pic", "baseline": "leader"}])
def test_stepped_loop_gives_the_fused_report(kw):
    """``fused=True`` runs the device-resident searches in every mode:
    permutation sampling (defaults, leader, early stop, the warm block),
    replacement sampling with its exact fallback decided on the device,
    and the PIC ring with its state on the device (a ring of the whole
    permutation, which runs the carried repair, a 2-round ring that
    recycles, a warm block, the leader); ``fused=False`` the stepped ones
    throughout.  The reports are identical, the loss bits included.  A
    batch of 20 gives searches of up to 15 rounds, past the stop of most
    of them."""
    n, k = 300, 3
    X = jdatasets.mnist_like(n, seed=2)
    a = BanditPAM(k, device="cpu", fused=True, seed=4, batch_size=20,
                  **kw).fit(X)
    b = BanditPAM(k, device="cpu", fused=False, seed=4, batch_size=20,
                  **kw).fit(X)
    for f in ("evals_by_phase", "swap_history", "build_rounds",
              "swap_exact_fallbacks", "n_swaps", "converged", "loss"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.medoids.tolist() == b.medoids.tolist()


def test_seed_draws_are_seeded_and_in_range():
    X = jdatasets.mnist_like(220, seed=0, d=16)
    kw = {"sampling": "replacement", "baseline": "leader"}
    a = BanditPAM(3, seed=5, device="cpu", **kw).fit(X)
    b = BanditPAM(3, seed=5, device="cpu", **kw).fit(X)
    assert a.medoids.tolist() == b.medoids.tolist()
    assert a.evals_by_phase == b.evals_by_phase
    # A round's batch: B draws in [0, n); R = ceil(n/B) rounds a search,
    # the same in any order of requests.
    src = rng.from_seed(0, "cpu", 3)
    late = src.swap_draw(0, 2, 10, 4)
    assert late.shape == (4,)
    for rnd in range(3):
        row = src.build_draw(1, rnd, 10, 4)
        assert row.shape == (4,) and 0 <= row.min() and row.max() < 10
    with pytest.raises(ValueError, match="at most 3"):
        src.build_draw(1, 3, 10, 4)
    assert torch.equal(rng.from_seed(0, "cpu", 3).swap_draw(0, 2, 10, 4),
                       late)


def test_array_draws_validate():
    n, b = 10, 4
    draws = np.zeros((2, 3, b), np.int64)
    src = rng.from_numpy(build_draws=draws, swap_draws=draws[:1])
    assert src.build_draw(1, 2, n, b).tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="only 3 rounds"):
        src.build_draw(0, 3, n, b)
    with pytest.raises(ValueError, match="only 1 searches"):
        src.swap_draw(1, 0, n, b)
    with pytest.raises(ValueError, match="batch size"):
        src.build_draw(0, 0, n, b + 1)
    with pytest.raises(ValueError, match="permutations"):
        src.build_perm(0, n)
    bad = rng.from_numpy(build_draws=draws + n, swap_draws=draws)
    with pytest.raises(ValueError, match="outside"):
        bad.build_draw(0, 0, n, b)
    perms = convert.layouts_from_reference(np.tile(np.arange(n), (2, 1)),
                                           np.tile(np.arange(n), (1, 1)))
    with pytest.raises(ValueError, match="replacement draws"):
        perms.swap_draw(0, 0, n, b)
    # a replacement fit asks for at most ceil(n/B) rounds per search
    X = jdatasets.mnist_like(250, seed=3, d=16)
    short = convert.draws_from_reference(*(d[:, :2] for d in
                                           jax_draws(0, 250, 2)))
    with pytest.raises(ValueError, match="only 2 rounds"):
        BanditPAM(2, sampling="replacement", device="cpu").fit(
            X, layouts=short)


def test_leader_cross_sums_match_between_backend_forms():
    """The torch backend takes the leader's g-row from the g block; the
    cuda backend derives it from one pairwise row of the leader.  Both
    forms give the same cross-sums (checked here with the plain
    versions on the CPU)."""
    from repro_torch.kernels import ops
    gen = np.random.default_rng(0)
    X = torch.from_numpy(jdatasets.mnist_like(200, seed=5, d=24))
    n, k = X.shape[0], 3
    be = engine.get_stats_backend("torch")
    ref = torch.from_numpy(gen.integers(0, n, 100))
    w = torch.ones(100)
    w[-9:] = 0.0
    dnear = torch.from_numpy(gen.uniform(1, 5, n).astype(np.float32))
    s, q, c = be.build_stats(X, ref, dnear[ref], w, torch.tensor(17),
                             metric="l2")
    dl = ops.pairwise_distance(X[17:18], X[ref], "l2")[0]
    lg = engine._build_g(dl[None, :], dnear[ref])[0] * w
    s2, q2, c2 = ops.build_g_stats(X, X[ref].contiguous(), dnear[ref], w, lg,
                                   metric="l2")
    torch.testing.assert_close(c, c2, rtol=1e-5, atol=1e-4)
    d1, d2, a = engine.medoid_cache(X, torch.tensor([3, 50, 120]),
                                    metric="l2")
    lead = torch.tensor(2 * n + 77)                # medoid 2, candidate 77
    s, q, c = be.swap_stats(X, ref, d1[ref], d2[ref], a[ref], w, k, lead,
                            metric="l2")
    dl = ops.pairwise_distance(X[77:78], X[ref], "l2")[0]
    lg = engine._swap_lead_g(dl, d1[ref], d2[ref], a[ref], torch.tensor(2))
    s2, q2, c2 = ops.swap_g_stats(X, X[ref].contiguous(), d1[ref], d2[ref],
                                  a[ref], w, k, lg, metric="l2")
    torch.testing.assert_close(c, c2.reshape(-1), rtol=1e-5, atol=1e-4)
    # the arm's own cross-sum is its square-sum
    torch.testing.assert_close(c[lead], q[lead], rtol=1e-5, atol=1e-5)
