"""The port's tile tuner (``repro_torch.core.tuning``) held against the
JAX package's (``repro.core.tuning``) on the CPU: the shape buckets, the
measured ledger and its resolution, the pins of the reference tile; then
the port's own parts: the shape indices the ``_tiled`` C entries take,
the wave model (its card facts patched in), the knobs of ``ops`` and a
fit's single resolution, with every launch of a fit, a batch and a
sharded fit in the tiles resolved for it.

Inputs are made with numpy; a fit's report is held against the JAX fit
on the seed-parity fixture (300 points, k = 3, l2, seed 0: ledger exact).
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.core import datasets as jdatasets
from repro.core import engine as jengine
from repro.core import tuning as jtuning
from repro_torch.core import BanditPAM, DistributedBanditPAM, engine, tuning
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "repro_torch" / "kernels" / "csrc"
H100 = tuning.H100
# 1, the powers of two and their neighbours, and sizes the fits use.
EDGES = sorted({1, 2, 3} | {v + e for p in range(1, 17) for v in [1 << p]
                            for e in (-1, 0, 1)} | {100, 784, 60000})


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    """Every test starts and ends with both ledgers empty."""
    tuning.clear_ledger()
    jtuning.clear_ledger()
    yield
    tuning.clear_ledger()
    jtuning.clear_ledger()
    tuning.heuristic.cache_clear()


def _cfg(tm, **kw):
    return tuning.TileConfig(tm=tm, **kw)


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("axis", ["n", "d", "k"])
def test_shape_key_buckets_match_reference(axis):
    for v in EDGES:
        n, d, k = (v, 784, 10) if axis == "n" else (
            (60000, v, 10) if axis == "d" else (60000, 784, v))
        mine = tuning.shape_key(n, d, k, "cpu", "torch")
        ref = jtuning.shape_key(n, d, k, "cpu", "jnp")
        assert mine[:3] == ref[:3], (axis, v)
        assert mine[3:] == ("cpu", "torch")


WALLS = [{"build": 2.0, "swap": 2.0},
         {"build": 0.5, "swap": 0.5},
         {"build": 0.0, "swap": 0.0},          # ignored: no wall
         {},                                   # ignored: no phase
         {"loss": 0.25, "stream": 0.5, "other": 9.0},
         {"build": -1.0},                      # ignored: not a wall
         {"swap": 0.75},
         {"build": 0.4, "swap": 0.1}]


def test_observe_keeps_the_references_bests():
    """The same walls under matching configs leave the same best per
    config in both ledgers, and both resolve to the measured best."""
    mine = [_cfg(128), _cfg(64), _cfg(32)]
    ref = [jtuning.TileConfig(tm=t) for t in (128, 256, 512)]
    for i, walls in enumerate(WALLS):
        c = i % 3
        tuning.observe(4096, 128, 8, mine[c], walls, "H100", "cuda")
        jtuning.observe(4096, 128, 8, ref[c], walls, device_kind="tpu",
                        backend="pallas")
    (key, best), = tuning.ledger_snapshot().items()
    (jkey, jbest), = jtuning.ledger_snapshot().items()
    assert key[:3] == jkey[:3]
    assert ({mine.index(c): v for c, v in best.items()}
            == {ref.index(c): v for c, v in jbest.items()})
    got = tuning.resolve_tile_config(4096, 128, 8, "H100", "cuda")
    jgot = jtuning.resolve_tile_config(4096, 128, 8, device_kind="tpu",
                                       backend="pallas")
    assert mine.index(got) == ref.index(jgot)


def test_resolution_flips_to_the_measured_best():
    """As ``tests/test_megakernel.py::test_tuner_heuristic_and_ledger``:
    a faster measurement flips the resolution; a neighbouring bucket
    still resolves to the heuristic."""
    base = tuning.resolve_tile_config(4096, 128, 8, "cpu", "torch")
    assert base.tb == tuning.REF_TILE
    cands = list(tuning.candidates(4096, 128, 8, "cpu", "torch"))
    assert base == cands[0] and len(cands) > 1
    other = next(c for c in cands if c != base)
    tuning.observe(4096, 128, 8, base, {"build": 2.0, "swap": 2.0}, "cpu",
                   "torch")
    tuning.observe(4096, 128, 8, other, {"build": 0.5, "swap": 0.5}, "cpu",
                   "torch")
    assert tuning.resolve_tile_config(4096, 128, 8, "cpu", "torch") == other
    assert tuning.resolve_tile_config(4000, 100, 5, "cpu", "torch") == other
    near = tuning.resolve_tile_config(4097, 128, 8, "cpu", "torch")
    assert near != other
    assert near == tuning.heuristic(4097, 128, 8, "cpu", "torch")
    # Another backend or card is another bucket.
    assert tuning.resolve_tile_config(4096, 128, 8, "cpu", "cuda-x") != other


def test_ledger_snapshot_is_a_copy_and_clear_empties_it():
    tuning.observe(100, 8, 2, _cfg(64), {"build": 1.0}, "cpu", "torch")
    snap = tuning.ledger_snapshot()
    (key, best), = snap.items()
    best[_cfg(32)] = 0.0
    snap.clear()
    assert tuning.ledger_snapshot() == {key: {_cfg(64): 1.0}}
    tuning.clear_ledger()
    assert tuning.ledger_snapshot() == {}


def _c_ref_tile(name: str) -> int:
    (v,) = re.findall(r"constexpr int64_t REF_TILE = (\d+);",
                      (CSRC / name).read_text())
    return int(v)


def test_reference_tile_is_pinned_everywhere():
    assert (tuning.REF_TILE == engine._EXACT_CHUNK == jtuning.REF_TILE
            == jengine._EXACT_CHUNK == _c_ref_tile("stream_stats.cu")
            == _c_ref_tile("swap_g.cu") == 512)
    assert tuning.TileConfig(tm=64).tb == tuning.REF_TILE


@pytest.mark.parametrize("n,d,k", [(100_000, 784, 10), (300, 33, 3),
                                   (1, 1, 1)])
def test_cpu_floor(n, d, k):
    """On the plain backend the floor: the row tile 128 (the JAX CPU
    floor's tm), the 104-column pairwise tile and top2's pick, the
    pinned reference tile, d rounded up to the stage width."""
    cfg = tuning.resolve_tile_config(n, d, k, "cpu", "torch")
    jcfg = jtuning.resolve_tile_config(n, d, k, device_kind="cpu",
                                       backend="pallas")
    assert cfg.tm == jcfg.tm == 128 and cfg.tb == jcfg.tb
    assert cfg == tuning.TileConfig(tm=128, tr=104,
                                    tk=tuning.top2_tile(k, "cpu"),
                                    dk=-(-d // 16) * 16)
    assert tuning.heuristic(n, d, k, H100, "torch") == dataclasses.replace(
        cfg, tk=tuning.top2_tile(k, H100))


def test_cpu_fit_resolves_once_observes_once_and_matches_jax(monkeypatch):
    X = jdatasets.mnist_like(300, seed=1)
    calls = {"resolve": [], "observe": []}
    resolve, observe = tuning.resolve_tile_config, tuning.observe

    def counted_resolve(*a, **kw):
        calls["resolve"].append(a)
        return resolve(*a, **kw)

    def counted_observe(*a, **kw):
        calls["observe"].append(a)
        return observe(*a, **kw)
    monkeypatch.setattr(tuning, "resolve_tile_config", counted_resolve)
    monkeypatch.setattr(tuning, "observe", counted_observe)
    got = BanditPAM(3, seed=0, device="cpu").fit(X)
    assert len(calls["resolve"]) == 1 and len(calls["observe"]) == 1
    assert calls["resolve"][0] == (300, 784, 3, "cpu", "torch")
    n, d, k, cfg, walls = calls["observe"][0][:5]
    assert (n, d, k) == (300, 784, 3) and walls is got.wall_by_phase
    assert cfg == tuning.heuristic(300, 784, 3, "cpu", "torch")
    (best,), = [list(v.values()) for v in tuning.ledger_snapshot().values()]
    assert best == pytest.approx(got.wall_by_phase["build"]
                                 + got.wall_by_phase["swap"])
    want = JKMedoids(3, metric="l2", seed=0).fit(X).report_
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert got.build_rounds == want.build_rounds
    assert got.evals_by_phase == want.evals_by_phase
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
    # A config forced through the ledger changes nothing on the CPU.
    tuning.observe(300, 784, 3, _cfg(32, tr=128, tk=40), {"build": 1e-9},
                   "cpu", "torch")
    again = BanditPAM(3, seed=0, device="cpu").fit(X)
    assert again.medoids.tolist() == got.medoids.tolist()
    assert again.swap_history == got.swap_history
    assert again.evals_by_phase == got.evals_by_phase
    assert again.loss == got.loss


# -- the shape indices ------------------------------------------------------

def test_shape_tables_and_indices():
    assert tuning.ROW_TILES == (128, 64, 32)
    assert tuning.KERNEL_SHAPES["build_g"] == ((128, 104), (64, 104),
                                               (32, 104))
    assert tuning.KERNEL_SHAPES["swap_g_from_cache"] == ((32, 0),)
    assert [tuning.row_index(t) for t in (128, 64, 32)] == [0, 1, 2]
    cfg = _cfg(64, tr=128, tk=72)
    # Narrow routes by the block's extents, 104 columns up to 104, then
    # the config's widest tile.
    assert tuning.pairwise_index(64, 128, 60000, 10) == 0
    assert tuning.pairwise_index(64, 128, 1, 60000) == 1
    assert tuning.pairwise_index(128, 128, 60000, 100) == 2
    assert tuning.pairwise_index(64, 128, 60000, 104) == 3
    assert tuning.pairwise_index(32, 104, 60000, 128) == 4
    assert tuning.pairwise_index(128, 128, 60000, 128) == 5
    assert tuning.pairwise_index(32, 128, 60000, 4096) == 7
    for i in range(2, 8):
        bm, bn = tuning.PAIRWISE_SHAPES[i]
        assert tuning.pairwise_index(bm, bn, 60000, 4096) == i
    assert tuning.pairwise_index(cfg.tm, cfg.tr, 8000, 128) == 6
    assert tuning.top2_index(cfg.tk) == 2
    assert tuning.row_index(cfg.tm) == 1
    for bad in (lambda: tuning.row_index(48),
                lambda: tuning.pairwise_index(128, 96, 500, 500),
                lambda: tuning.pairwise_index(48, 104, 500, 8),
                lambda: tuning.top2_index(64)):
        with pytest.raises(ValueError):
            bad()


def _c_top2_table():
    src = (CSRC / "stream_g.cu").read_text()
    us = [int(v) for v in re.search(r"SHAPE_US\[SHAPES\] = \{([^}]*)\}",
                                    src).group(1).split(",")]
    return dict(zip((16, 40, 72, 104), us))


def test_top2_pick_by_k_is_stream_g_cu_pick_shape(monkeypatch):
    """Under the table of ``stream_g.cu`` (rt_top2's), ``top2_tile`` makes
    ``pick_shape``'s choice at every k (the narrower on a tie)."""
    table = _c_top2_table()
    monkeypatch.setitem(tuning.TILE_US, "C", {"top2": table})

    def pick_shape(k):
        best, best_us = 0, None
        for s, bn in enumerate((16, 40, 72, 104)):
            us = -(-k // bn) * table[bn]
            if best_us is None or us < best_us:
                best, best_us = s, us
        return (16, 40, 72, 104)[best]
    for k in range(1, 320):
        assert tuning.top2_tile(k, "C") == pick_shape(k), k
    assert tuning.top2_tile(10, "C") == 16
    assert tuning.top2_tile(65, "C") == 72
    assert tuning.top2_tile(200, "C") == 104


def test_wave_model(monkeypatch):
    """The heuristic under patched card facts: one block an SM at 8,000
    rows leaves SMs idle at 128 rows, so a smaller row tile wins there;
    at 60,000 rows the 128-row tile's two waves win; a 128-column tile
    covers a sharded round's 128 columns in one walk."""
    assert tuning.wave_us(63, 132, 2, (10.0, 16.0)) == 10.0
    assert tuning.wave_us(469, 132, 2, (10.0, 16.0)) == 32.0
    assert tuning.wave_us(300, 132, 2, (10.0, 16.0)) == 26.0
    assert tuning.wave_us(938, 132, 4, (6.0, 17.0)) == 2 * 17.0
    monkeypatch.setitem(tuning.TILE_US, "card", {
        "rows": {128: (100.0, 160.0), 64: (55.0, 180.0), 32: (30.0, 200.0)},
        "pairwise": {(bm, bn): (t * bn / 104, f * bn / 104)
                     for (bm, (t, f)) in ((128, (100.0, 160.0)),
                                          (64, (55.0, 180.0)),
                                          (32, (30.0, 200.0)))
                     for bn in (104, 128)},
        "top2": {16: 100.0, 40: 153.0, 72: 233.0, 104: 310.0}})
    monkeypatch.setattr(tuning, "sm_count", lambda: 132)
    per = {(k, s): v for k in ("build_g", "pairwise") for s, v in
           enumerate((2, 4, 4) if k == "build_g"
                     else (4, 4, 2, 4, 4, 2, 3, 4))}
    monkeypatch.setattr(tuning, "blocks_per_sm",
                        lambda kernel, s, k=1: per[kernel, s])
    tuning.heuristic.cache_clear()
    big = tuning.heuristic(60000, 784, 10, "card", "cuda")
    small = tuning.heuristic(8000, 784, 10, "card", "cuda")
    assert big.tm == 128 and small.tm < 128
    assert big.tr == small.tr == 128 and big.tk == 16
    assert tuning.resolve_tile_config(8000, 784, 10, "card", "cuda") == small
    cands = tuning.candidates(8000, 784, 10, "card", "cuda")
    assert cands[0] == small
    assert {c.tm for c in cands} == {128, 64, 32}
    assert {c.tr for c in cands} == {104, 128}
    assert {c.tk for c in cands} == {16, 40, 72, 104}
    # Row tiles past twice n are not swept (the JAX package's rule).
    assert {c.tm for c in tuning.candidates(20, 8, 2, "card", "cuda")} == {
        32, tuning.heuristic(20, 8, 2, "card", "cuda").tm}


# -- the knobs of ops ---------------------------------------------------------

def test_ops_knobs_validate_and_leave_the_plain_values():
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((40, 12)).astype(np.float32))
    y = torch.from_numpy(g.standard_normal((30, 12)).astype(np.float32))
    want = ops.pairwise_distance(x, y)
    for tm in tuning.ROW_TILES:
        for tr in tuning.PAIRWISE_COLS:
            assert torch.equal(ops.pairwise_distance(x, y, tm=tm, tr=tr),
                               want)
    with pytest.raises(ValueError):
        ops.pairwise_distance(x, y, tm=48)
    with pytest.raises(ValueError):
        ops.pairwise_distance(x, y[:20], tr=96)
    med = y[:4].contiguous()
    d1 = ops.stream_top2(x, med)
    for _, bn in tuning.TOP2_SHAPES:
        assert all(torch.equal(a, b) for a, b in
                   zip(ops.stream_top2(x, med, tr=bn), d1))
    with pytest.raises(ValueError):
        ops.stream_top2(x, med, tr=64)
    w = torch.ones(30)
    dn = torch.full((30,), float("inf"))
    got = ops.build_g_stats(x, y, dn, w, tm=32)
    assert all(torch.equal(a, b) for a, b in
               zip(got, ops.build_g_stats(x, y, dn, w)))
    with pytest.raises(ValueError):
        ops.build_g_stats(x, y, dn, w, tm=96)
    a = torch.zeros(30, dtype=torch.int32)
    dxy = ops.pairwise_distance(x, y)
    ops.swap_g_stats_cached(dxy, dn, dn, a, w, 1, tm=32)
    with pytest.raises(ValueError):
        ops.swap_g_stats_cached(dxy, dn, dn, a, w, 1, tm=128)


# -- every launch of a fit in the fit's tiles --------------------------------

TILE_KNOBS = {"pairwise_distance": ("tm", "tr"), "pairwise_lanes": ("tm", "tr"),
              "build_g_stats": ("tm",), "swap_g_stats": ("tm",),
              "stream_build_g_stats": ("tm",), "stream_swap_g_stats": ("tm",),
              "build_g_lanes_stats": ("tm",), "swap_g_lanes_stats": ("tm",),
              "stream_top2": ("tr",), "stream_top2_lanes": ("tr",)}


class _Recorder:
    """``ops`` with every call's tile knobs recorded (the plain versions
    run: the tensors are on the CPU)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(ops, name)

        def call(*a, **kw):
            self.calls.append((name, {k: kw.get(k) for k in
                                      TILE_KNOBS.get(name, ())}))
            return fn(*a, **kw)
        return call


class _RecordingCuda(engine.CudaStatsBackend):
    """The ``"cuda"`` backend's code path over CPU tensors."""

    recorder = None

    def _ops(self, t):
        return _RecordingCuda.recorder


@pytest.fixture
def recording(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_RecordingCuda, "recorder", rec)
    monkeypatch.setitem(engine._BACKENDS, "rec", _RecordingCuda())
    yield rec


def _want(cfg):
    return {"tm": cfg.tm, "tr": cfg.tr}, {"tr": cfg.tk}


def _assert_in_tiles(rec, cfg, kernels):
    pw, top2 = _want(cfg)
    seen = set()
    for name, knobs in rec.calls:
        seen.add(name)
        if name.startswith("pairwise"):
            assert knobs == pw, (name, knobs)
        elif name.startswith("stream_top2"):
            assert knobs == top2, (name, knobs)
        elif name in TILE_KNOBS:
            assert knobs == {"tm": cfg.tm}, (name, knobs)
    assert set(kernels) <= seen, seen


FORCED = tuning.TileConfig(tm=32, tr=128, tk=40, dk=784)


@pytest.mark.parametrize("kw,kernels", [
    ({}, ("build_g_stats", "swap_g_stats", "stream_top2",
          "pairwise_distance")),
    ({"reuse": "pic"}, ("pairwise_distance", "swap_g_stats_cached",
                        "stream_top2")),
    ({"sampling": "replacement", "baseline": "leader"},
     ("build_g_stats", "swap_g_stats", "stream_top2")),
])
def test_fit_launches_in_its_resolved_tiles(recording, kw, kernels):
    X = jdatasets.mnist_like(300, seed=1)
    tuning.observe(300, 784, 3, FORCED, {"build": 1e-9}, "cpu", "rec")
    got = BanditPAM(3, seed=0, device="cpu", backend="rec", **kw).fit(X)
    _assert_in_tiles(recording, FORCED, kernels)
    plain = BanditPAM(3, seed=0, device="cpu", **kw).fit(X)
    assert got.medoids.tolist() == plain.medoids.tolist()
    assert got.evals_by_phase == plain.evals_by_phase


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_batch_launches_in_its_resolved_tiles(recording, reuse):
    Xs = [jdatasets.mnist_like(n, seed=i)[:, :16].copy()
          for i, n in enumerate((120, 97, 150))]
    # The batch resolves for the rows one launch covers: 3 lanes of 152.
    tuning.observe(3 * 152, 16, 3, FORCED, {"build": 1e-9}, "cpu", "rec")
    got = BanditPAM(3, device="cpu", backend="rec", batch_size=20,
                    reuse=reuse).fit_batch(Xs, seeds=[0, 1, 2])
    kernels = (("build_g_lanes_stats", "swap_g_lanes_stats")
               if reuse == "none" else ("pairwise_lanes",))
    _assert_in_tiles(recording, FORCED, kernels + ("stream_top2_lanes",))
    plain = BanditPAM(3, device="cpu", batch_size=20,
                      reuse=reuse).fit_batch(Xs, seeds=[0, 1, 2])
    assert got.medoids.tolist() == plain.medoids.tolist()


@pytest.mark.parametrize("reuse", ["none", "pic"])
def test_sharded_fit_launches_in_its_resolved_tiles(recording, reuse):
    X = jdatasets.mnist_like(300, seed=1)
    tuning.observe(300, 784, 3, FORCED, {"build": 1e-9}, "cpu", "rec")
    got = DistributedBanditPAM(3, device="cpu", backend="rec",
                               reuse=reuse).fit(X)
    _assert_in_tiles(recording, FORCED, ("pairwise_distance",
                                         "stream_top2"))
    # The sharded fit does not observe: the ledger holds the forced
    # config's wall alone.
    assert list(tuning.ledger_snapshot().values()) == [{FORCED: 1e-9}]
    plain = DistributedBanditPAM(3, device="cpu", reuse=reuse).fit(X)
    assert got.medoids.tolist() == plain.medoids.tolist()
    assert got.evals_by_phase == plain.evals_by_phase


def test_context_binds_the_backend():
    ctx = engine.FitContext(mode="none", backend="cuda", tiles=FORCED)
    assert isinstance(ctx.stats, engine.CudaStatsBackend)
    assert ctx.stats.tiles == FORCED and ctx.stats is not \
        engine.get_stats_backend("cuda")
    assert engine.get_stats_backend(ctx.stats) is ctx.stats
    plain = engine.FitContext(mode="none", backend="torch", tiles=FORCED)
    assert plain.stats is engine.get_stats_backend("torch")
    assert engine.get_stats_backend("cuda").tiles is None
