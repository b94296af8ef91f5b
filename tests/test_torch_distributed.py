"""The sharded fit (``repro_torch.core.distributed``) held against the JAX
sharded fit (``repro.core.distributed.DistributedBanditPAM``,
``backend="jnp"``) on the CPU, at 1, 2 and 4 shards.

* One shard runs in this process, against a one-device mesh.
* Two and four shards: the port's ranks are processes of a ``gloo``
  group (``distributed.spawn_fits``, one intra-op thread each); the JAX
  package runs every multi-shard case once, in one subprocess with four
  simulated CPU devices, started when the module's first test starts.

``mnist_like(257, ...)``, k = 3 (257 is prime, so every shard count pads).
The port runs its default, device-resident loop (``fused=True``).
Medoids, swap history (indices), swaps, convergence, build rounds and
exact fallbacks are equal; loss and swap losses agree to rtol 1e-5 plus
the l2 near-0 allowance of ROADMAP §C, ``sqrt(2·d·2^-24)·‖x‖`` for each
of the k medoid rows (a point's distance to itself is the square root of
each package's summation noise; at ``mnist_like(10)`` it moves the loss
of 43.26 by 0.0047); each phase's fresh and cached ledger is
exact but in ``MARGIN_CASES``, held within 10·B for the reason given
there.  Every rank returns the identical report, loss bits included,
and the report of its stepped twin (``fused=False``, ``TWINS``), run in
the same set of ranks.  Every process group, spawn and subprocess has a
timeout.
"""

import datetime
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.api import KMedoids as JKMedoids
from repro.core import datasets as jdatasets
from repro.core import distributed as jdist
from repro_torch.api import KMedoids
from repro_torch.core import adaptive, banditpam, datasets, threefry
from repro_torch.core import distributed as tdist
from repro_torch.core import BanditPAM, DistributedBanditPAM, MedoidCurator
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, SEED, B = 257, 3, 0, 128
TIMEOUT = 300   # seconds: the JAX subprocess and each set of ranks

# name -> (shards, (n, data seed), k, params).  The multi-swap case's data
# gives three accepted swaps, so its carried moments are repaired three
# times.  n = 3 below four shards runs at k = 1: at k = 2 the two optimal
# medoid pairs (either point of the closest pair left out) tie exactly
# but for each package's l2 noise at a point's distance to itself, which
# picks one of them.
CASES = {
    "2-none": (2, (N, 0), K, {}),
    "2-pic": (2, (N, 0), K, {"reuse": "pic"}),
    "4-none": (4, (N, 0), K, {}),
    "4-pic": (4, (N, 0), K, {"reuse": "pic"}),
    "4-pic-one-round-ring": (4, (N, 0), K, {"reuse": "pic",
                                            "cache_width": B}),
    "4-pic-multi-swap": (4, (N, 1), K, {"reuse": "pic"}),
    "4-empty-shards": (4, (10, 2), 2, {}),
    "4-n-below-shards": (4, (3, 4), 1, {}),
}
# Cases whose ledger is held within 10·B (the rest exactly), by phase.
# The packages' float32 pairwise blocks differ in the last bits (about
# half the entries at this fixture), so an arm whose kill margin sits
# within that rounding dies a round earlier or later, or one more arm
# survives to the exact fallback (n evaluations): at one shard BUILD
# pays 184,395 against the JAX fit's 184,138.  At four shards gloo's
# ring sums the ranks' statistics in another order than the JAX CPU
# psum, and SWAP pays 261,202 against 261,074 (one arm-round).
MARGIN_CASES = {"1-none", "4-none"}
# Stepped twins (fused=False), each held identical to the device-resident
# fit of the same case on every rank: name -> (shards, (n, data seed), k,
# params).  The B = 4 cases are not compared with the JAX package; their
# searches stop early (at two shards BUILD runs 65, 19 and 65 of 65
# rounds), so rounds past the stop run masked, each with its all-reduce.
TWINS = {
    "2-none": CASES["2-none"],
    "2-pic": CASES["2-pic"],
    "2-pic-b4": (2, (N, 1), K, {"reuse": "pic", "batch_size": 4}),
    "4-none": CASES["4-none"],
    "4-pic-multi-swap": CASES["4-pic-multi-swap"],
    "4-pic-b4": (4, (N, 0), K, {"reuse": "pic", "batch_size": 4}),
}

_JAX_REFS = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.core import datasets
    from repro.core.distributed import DistributedBanditPAM

    out = {}
    for name, (shards, (n, ds), k, params) in json.loads(
            sys.argv[1]).items():
        mesh = Mesh(np.asarray(jax.devices()[:shards]), ("data",))
        r = DistributedBanditPAM(k, mesh, metric="l2", seed=%d,
                                 backend="jnp", **params).fit(
            datasets.mnist_like(n, seed=ds))
        out[name] = {
            "medoids": [int(m) for m in r.medoids], "loss": float(r.loss),
            "swap_history": [[int(a), int(b), float(c)]
                             for a, b, c in r.swap_history],
            "n_swaps": r.n_swaps, "converged": bool(r.converged),
            "build_rounds": [int(v) for v in r.build_rounds],
            "swap_exact_fallbacks": int(r.swap_exact_fallbacks),
            "evals_by_phase": {p: int(v)
                               for p, v in r.evals_by_phase.items()}}
    print(json.dumps(out))
""" % SEED)


@pytest.fixture(scope="module", autouse=True)
def jax_proc():
    """The JAX multi-shard references, computed in a subprocess with four
    simulated devices while this module's in-process tests run."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFS, json.dumps(CASES)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_refs(jax_proc):
    out, err = jax_proc.communicate(timeout=TIMEOUT)
    assert jax_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _spawn(cases, shards):
    """``spawn_fits`` on ``shards`` gloo ranks, one intra-op thread each
    (the spawned processes read ``OMP_NUM_THREADS``)."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("OMP_NUM_THREADS", "1")
        return tdist.spawn_fits(cases, shards, device="cpu",
                                timeout=TIMEOUT)


@pytest.fixture(scope="module")
def port_fits():
    """Every multi-shard case on the port's gloo ranks, and every twin's
    stepped fit (under ``"<name> stepped"``) and resident fit: one set of
    processes per shard count."""
    runs = dict(CASES)
    for nm, (shards, nds, k, params) in TWINS.items():
        runs.setdefault(nm, (shards, nds, k, params))
        runs[f"{nm} stepped"] = (shards, nds, k, dict(params, fused=False))
    out = {}
    for shards in (2, 4):
        names = [nm for nm, c in runs.items() if c[0] == shards]
        cases = [(datasets.mnist_like(n, seed=ds), k, params)
                 for _, (n, ds), k, params in (runs[nm] for nm in names)]
        out.update(zip(names, _spawn(cases, shards)))
    return out


def allreduce_bounds(allreduces, build_rounds, k):
    """The resident fit's BUILD all-reduces: one a round enqueued, so at
    least one a round run and at most ROUNDS_PER_READ − 1 more a search."""
    per = adaptive.ROUNDS_PER_READ
    return (sum(build_rounds) <= allreduces["build"]
            <= sum(build_rounds) + (per - 1) * k)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _as_dict(r) -> dict:
    return {"medoids": [int(m) for m in r.medoids], "loss": float(r.loss),
            "swap_history": [[int(a), int(b), float(c)]
                             for a, b, c in r.swap_history],
            "n_swaps": r.n_swaps, "converged": bool(r.converged),
            "build_rounds": list(r.build_rounds),
            "swap_exact_fallbacks": r.swap_exact_fallbacks,
            "evals_by_phase": dict(r.evals_by_phase)}


def near0(X, k: int) -> float:
    """k medoid rows' l2 self-distance noise: sqrt(2·d·2^-24)·max ‖x‖."""
    X = np.asarray(X, np.float64)
    return k * np.sqrt(2 * X.shape[1] * 2.0 ** -24) * np.linalg.norm(
        X, axis=1).max()


def assert_matches(got, want: dict, margin: bool, atol: float):
    got = _as_dict(got)
    for f in ("medoids", "n_swaps", "converged", "build_rounds",
              "swap_exact_fallbacks"):
        assert got[f] == want[f], (f, got, want)
    assert ([h[:2] for h in got["swap_history"]]
            == [h[:2] for h in want["swap_history"]])
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + atol
    for (_, _, lg), (_, _, lw) in zip(got["swap_history"],
                                      want["swap_history"]):
        assert abs(lg - lw) <= 1e-5 * abs(lw) + atol
    ev, wv = got["evals_by_phase"], want["evals_by_phase"]
    assert ev.keys() == wv.keys()
    if margin:
        assert all(abs(ev[p] - v) <= 10 * B for p, v in wv.items()), (ev, wv)
    else:
        assert ev == wv


# -- the draw chain and the PIC layout --------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_draw_chain_matches_jax(seed):
    """``_phase_key`` / ``_round_key`` / ``_shard_draws`` equal the JAX
    functions bit for bit over steps, rounds, shards and valid counts
    (0: an all-padding shard)."""
    for tag in (tdist._BUILD_TAG, tdist._SWAP_TAG):
        for step in (0, 3):
            pk = tdist._phase_key(seed, tag, step)
            jpk = jdist._phase_key(seed, tag, step)
            assert pk == tuple(int(w) for w in np.asarray(jpk))
            for rnd in (0, 1, 7):
                rk = tdist._round_key(pk, rnd)
                jrk = jdist._round_key(jpk, rnd)
                for ax, v, b_loc in ((0, 65, 32), (3, 62, 32), (1, 129, 64),
                                     (3, 0, 32), (0, 1, 128)):
                    got = tdist._shard_draws(rk, ax, v, b_loc).numpy()
                    want = np.asarray(jdist._shard_draws(jrk, ax, v, b_loc))
                    np.testing.assert_array_equal(got, want)


def test_search_draws_are_the_chain():
    """A search's chunked draws (``_Draws``) are ``_shard_draws`` of each
    round, across a chunk boundary."""
    pk = tdist._phase_key(SEED, tdist._SWAP_TAG, 2)
    draws = tdist._Draws(pk, 2, 65, 32, "cpu")
    for rnd in (0, 5, tdist.DRAW_CHUNK - 1, tdist.DRAW_CHUNK, 70):
        want = tdist._shard_draws(tdist._round_key(pk, rnd), 2, 65, 32)
        assert torch.equal(draws(rnd), want)


@pytest.mark.parametrize("n,shards", [(257, 1), (257, 2), (257, 4),
                                      (10, 4), (3, 4)])
def test_pic_layout_matches_jax(n, shards, mesh1):
    """The per-shard walks and weights and the global layout equal the
    JAX ``_pic_layout`` (run on a one-device mesh with the shard count
    set, since it only places its arrays there)."""
    est = jdist.DistributedBanditPAM(K, mesh1, seed=SEED, reuse="pic")
    est.n_shards, est.batch_size = shards, B
    key, ckey = jax.random.split(jax.random.PRNGKey(SEED))
    lperm, lw, pidx_g, pw_g, _, _ = est._pic_layout(n, ckey)
    got = tdist._pic_layout(n, shards, B // shards,
                            threefry.split(threefry.PRNGKey(SEED))[1])
    for g, w in zip(got, (lperm, lw, pidx_g, pw_g)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3].sum() == n


# -- the search over an explicit layout --------------------------------------

def _host_built(monkeypatch):
    """Route every search of ``BanditPAM.fit`` through a layout made on
    the host (``explicit_layout``) from the cyclic one's tables."""
    orig = banditpam.device_search

    def spy(**kw):
        lay = kw.get("layout")
        if lay is not None:
            kw["layout"] = adaptive.explicit_layout(
                lay.idx.numpy(), lay.w.numpy(), kw["batch_size"],
                lay.idx.device)
        return orig(**kw)

    monkeypatch.setattr(banditpam, "device_search", spy)


SEARCH_MODES = [
    {}, {"fused": False}, {"baseline": "leader"}, {"reuse": "pic"},
    {"reuse": "pic", "cache_width": 200, "baseline": "leader"},
    {"cache_cols": 200}]


@pytest.mark.parametrize("kw", SEARCH_MODES)
def test_host_built_layout_gives_the_device_built_report(kw, monkeypatch):
    """``adaptive``'s search over the cyclic tiling's tables copied from
    the host (the sharded fit's route) returns the report of the tables
    made on the device, loss bits included, in the fused and stepped
    loops, with the leader, the PIC carry and the warm block."""
    X = datasets.mnist_like(300, seed=4, d=16)
    want = BanditPAM(3, seed=1, device="cpu", **kw).fit(X)
    _host_built(monkeypatch)
    got = BanditPAM(3, seed=1, device="cpu", **kw).fit(X)
    for f in ("swap_history", "build_rounds", "evals_by_phase", "n_swaps",
              "converged", "loss", "host_reads_by_phase"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.medoids.tolist() == want.medoids.tolist()


# The reports of SEARCH_MODES' fits at one intra-op thread from the search
# before it took an explicit layout (it tiled ``perm`` itself), loss bits
# as float.hex: every mode swaps 299 for 293 once, with loss 0x1.955b02p+7.
# The two PIC fits' host reads are those of the device-resident loop they
# run since it took the PIC ring: the first BUILD search runs its whole
# budget of 3 rounds and reads its round count at its end, after which
# the ring's window cannot move (stepped they read 13 + 8 and 13 + 11
# times, their ledgers as below).
_BEFORE_LAYOUT = [
    ({"build": 179700, "swap": 129300}, {"build": 1, "swap": 3}),
    ({"build": 179700, "swap": 129300}, {"build": 13, "swap": 11}),
    ({"build": 173100, "swap": 128500}, {"build": 1, "swap": 3}),
    ({"build": 90900, "build_cached": 120300, "swap": 3600,
      "swap_cached": 143800}, {"build": 2, "swap": 3}),
    ({"build": 150900, "build_cached": 60500, "swap": 63600,
      "swap_cached": 66400}, {"build": 2, "swap": 3}),
    ({"cache_warm": 60000, "build": 34900, "swap": 25800},
     {"build": 1, "swap": 3}),
]


@pytest.mark.parametrize("kw,before", zip(SEARCH_MODES, _BEFORE_LAYOUT))
def test_explicit_cyclic_layout_gives_todays_report(kw, before):
    """The single fit, whose search now walks ``cyclic_layout``, returns
    the report the search gave when it tiled the permutation itself:
    medoids, swaps, build rounds, ledger, host reads and loss bits."""
    X = datasets.mnist_like(300, seed=4, d=16)
    r = BanditPAM(3, seed=1, device="cpu", **kw).fit(X)
    loss = float.fromhex("0x1.955b020000000p+7")
    assert r.medoids.tolist() == [293, 91, 114]
    assert [(int(a), int(b), float(c)) for a, b, c in r.swap_history] == [
        (299, 293, loss)]
    assert (r.build_rounds, r.n_swaps, r.converged) == ([3, 3, 3], 1, True)
    assert (r.evals_by_phase, r.host_reads_by_phase) == before
    assert float(r.loss) == loss


def test_layout_must_cover_the_references():
    lay = adaptive.explicit_layout(np.arange(20), np.ones(20, np.float32),
                                   10, "cpu")
    kw = dict(stats_fn=None, n_arms=20, batch_size=10,
              log_term=torch.tensor(1.0),
              active_init=torch.ones(20, dtype=torch.bool), layout=lay)
    with pytest.raises(ValueError, match="cover 20"):
        adaptive.device_search(n_ref=30, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        adaptive.device_search(n_ref=20, draw=lambda rnd: torch.arange(10),
                               **kw)


# -- one shard, in this process ----------------------------------------------

@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_one_shard_matches_jax(reuse, mesh1, monkeypatch):
    X = jdatasets.mnist_like(N, seed=0)
    want = jdist.DistributedBanditPAM(K, mesh1, seed=SEED, backend="jnp",
                                      reuse=reuse).fit(X)
    swaps = []
    orig = tdist.device_search

    def spy(**kw):
        res = orig(**kw)
        if kw["phase"] == "swap":
            swaps.append(int(res.rounds) - kw.get("init_rounds", 0))
        return res
    monkeypatch.setattr(tdist, "device_search", spy)
    got = DistributedBanditPAM(K, seed=SEED, device="cpu",
                               reuse=reuse).fit(X)
    assert got.solver == "banditpam_dist" and got.metric == "l2"
    assert set(got.wall_by_phase) == {"build", "swap"}
    assert got.dispatches_by_phase == {}
    assert_matches(got, _as_dict(want), f"1-{reuse}" in MARGIN_CASES,
                   near0(X, K))
    # The resident loop: a read every 32 rounds of a search (once more at
    # the budget's end for a PIC BUILD search whose window can grow), one
    # at BUILD's end, one a SWAP iteration and one for the first loss.
    per = adaptive.ROUNDS_PER_READ
    assert len(swaps) == got.n_swaps + 1
    assert (got.host_reads_by_phase["build"]
            <= sum(-(-r // per) for r in got.build_rounds) + K + 1)
    assert (got.n_swaps + 2 <= got.host_reads_by_phase["swap"]
            <= sum(-(-r // per) for r in swaps) + 2 * len(swaps))


@pytest.fixture()
def world1():
    """A one-rank ``gloo`` group in this process (the default group)."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=TIMEOUT))
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_facade_round_trip_matches_jax(mesh1, world1):
    """``KMedoids(solver="banditpam_dist")`` on the default group (one
    rank of ``gloo``: one all-reduce a round enqueued) against the JAX
    facade on a one-device mesh: report, labels and predict.  (The
    stepped fit's one all-reduce a round run is held exactly in
    ``tests/test_torch_distributed_resident.py``.)"""
    X = jdatasets.mnist_like(N, seed=0)
    want = JKMedoids(K, solver="banditpam_dist", metric="l2", seed=SEED,
                     backend="jnp", mesh=mesh1, reuse="pic",
                     cache_width=512).fit(X)
    assert tdist.default_group() is world1
    tdist.reset_allreduce_counts()
    got = KMedoids(K, solver="banditpam_dist", metric="l2", seed=SEED,
                   device="cpu", reuse="pic", cache_width=512).fit(X)
    counts = tdist.allreduce_counts()
    r = got.report_
    assert_matches(r, _as_dict(want.report_), False, near0(X, K))
    assert r.solver == "banditpam_dist" and r.cached_evals > 0
    np.testing.assert_array_equal(got.labels_, np.asarray(want.labels_))
    np.testing.assert_array_equal(got.predict(X), got.labels_)
    # One all-reduce a round enqueued; one more per carried repair.
    assert allreduce_bounds(counts, r.build_rounds, K)
    assert counts["swap"] >= r.n_swaps + 1


def test_carried_repair_runs(monkeypatch):
    """The multi-swap fixture repairs its carried moments after each
    accepted swap, over changed points, at one shard and at four
    (``test_multi_shard_matches_jax[4-pic-multi-swap]``)."""
    changed = []
    orig = tdist._Fit._carry

    def spy(self, *a):
        out = orig(self, *a)
        changed.append(int(out[2]))
        return out

    monkeypatch.setattr(tdist._Fit, "_carry", spy)
    r = DistributedBanditPAM(K, seed=SEED, device="cpu", reuse="pic").fit(
        datasets.mnist_like(N, seed=1))
    assert r.n_swaps == 3 and len(changed) == r.n_swaps
    assert all(c > 0 for c in changed)
    assert r.evals_by_phase["swap_cached"] > N * sum(changed)


# -- two and four shards: gloo ranks against the JAX subprocess --------------

@pytest.mark.parametrize("name", list(CASES))
def test_multi_shard_matches_jax(name, port_fits, jax_refs):
    _, (n, ds), k, _ = CASES[name]
    assert_matches(port_fits[name][0].report, jax_refs[name],
                   name in MARGIN_CASES, near0(datasets.mnist_like(n, ds), k))


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same_report(name, port_fits):
    """Identical reports on every rank, loss bits included, and the same
    all-reduces: one a bandit round enqueued, one more per carried
    repair."""
    fits = port_fits[name]
    assert len(fits) == CASES[name][0]
    want = fits[0].report
    for f in fits:
        assert _as_dict(f.report) == _as_dict(want)
        assert f.report.host_reads_by_phase == want.host_reads_by_phase
        assert f.report.cached_evals == want.cached_evals
        assert f.allreduces == fits[0].allreduces
    assert allreduce_bounds(fits[0].allreduces, want.build_rounds,
                            CASES[name][2])


@pytest.mark.parametrize("name", list(TWINS))
def test_resident_ranks_match_their_stepped_twin(name, port_fits):
    """Every rank's resident report is its stepped twin's (loss bits
    included), read fewer times; every rank makes the same all-reduces,
    the stepped fit one a BUILD round run, the resident one within its
    bounds."""
    shards, _, k, _ = TWINS[name]
    fits, twins = port_fits[name], port_fits[f"{name} stepped"]
    assert len(fits) == len(twins) == shards
    want = twins[0].report
    for f, t in zip(fits, twins):
        assert _as_dict(f.report) == _as_dict(t.report) == _as_dict(want)
        assert f.report.cached_evals == want.cached_evals
        assert f.allreduces == fits[0].allreduces
        assert t.allreduces == twins[0].allreduces
    for ph in ("build", "swap"):
        assert (fits[0].report.host_reads_by_phase[ph]
                < want.host_reads_by_phase[ph])
    assert twins[0].allreduces["build"] == sum(want.build_rounds)
    assert allreduce_bounds(fits[0].allreduces, want.build_rounds, k)
    if "b4" in name:
        assert fits[0].allreduces["build"] > sum(want.build_rounds)


# -- MedoidCurator -----------------------------------------------------------

def test_curator_gates_on_the_group_size(monkeypatch, world1):
    """No group and a one-rank group run the single-device solver; a group
    of more than one rank takes the sharded path."""
    emb = datasets.mnist_like(40, seed=5)

    class Boom:
        def __init__(self, *a, **kw):
            raise AssertionError("distributed path taken")

    monkeypatch.setattr(tdist, "DistributedBanditPAM", Boom)
    for group in (None, world1):
        meds, assign = MedoidCurator(2, group, metric="l2",
                                     device="cpu").curate(emb)
        assert meds.shape == (2,) and assign.shape == (40,)
    with monkeypatch.context() as m:
        m.setattr(tdist.dist, "get_world_size", lambda g: 4)
        with pytest.raises(AssertionError, match="distributed path taken"):
            MedoidCurator(2, world1, metric="l2", device="cpu").curate(emb)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_curator_matches_jax(metric, mesh1):
    emb = jdatasets.mnist_like(120, seed=5)
    want = jdist.MedoidCurator(3, mesh1, metric=metric).curate(emb)
    got = MedoidCurator(3, metric=metric, device="cpu").curate(emb)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_a_rank_that_raises_ends_the_ranks():
    """A rank's error reaches the caller and every rank's process ends
    (each group also has a collective timeout)."""
    with pytest.raises(Exception, match="need n > k"):
        _spawn([(datasets.mnist_like(3, seed=0), 3, {})], 2)


def test_spawn_fits_defaults_to_the_card(monkeypatch):
    """``spawn_fits`` without ``device`` targets the card, as every entry
    point does (``core.device``): without one it raises before it starts
    a rank; it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **kw: started.append(a))
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdist.spawn_fits([(datasets.mnist_like(10, seed=0), 3, {})], 2)
    assert started == []
