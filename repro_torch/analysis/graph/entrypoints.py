"""The graph registry of the port: every hot entry point, by name
(counterpart of ``repro.analysis.graph.entrypoints``).

Each :class:`GraphSpec` carries the JAX registry's name, tags and
declared contracts, and ``build(device, backend)``: it makes the entry
point's inputs at the canonical small shapes (``N, D, K, B`` = 640, 8,
8, 32, from ``numpy.random.default_rng(seed)``) and returns a
:class:`Prepared`: the call to survey once, its tensor inputs, the
carried buffers it must write in place (GRC005) and the collectives it
declares (GRC003).  Setup (a fit's context and ring, a BUILD before a
SWAP iteration, a one-rank group) runs in ``build`` and is not surveyed.
``port`` names the port's function where it differs from the JAX one
(:func:`counterpart`).

* ``core._build_fused[none|pic]`` -> ``BanditPAM._build``: the k
  resident BUILD searches, in ``reuse="none"`` and ``"pic"`` (a ring of
  ``W_ROUNDS`` = 2 rounds);
* ``core._swap_iter[none|pic]`` -> ``BanditPAM._swap`` at
  ``max_swaps=1``: the first loss read and one SWAP iteration, from the
  BUILD's medoids;
* ``core._build_batch[pic]`` / ``_swap_batch[pic]`` -> ``batch.
  _build_batch`` / ``_swap_batch`` over ``BF`` = 2 lanes (``T`` = 3 SWAP
  iterations);
* ``engine.*``: ``total_loss``, ``medoid_cache``, ``exact_build_means``,
  ``exact_swap_means``;
* ``kernels.stream_*`` -> ``ops.stream_build_g_stats``,
  ``stream_swap_g_stats`` (64 candidate rows against the N references)
  and ``stream_top2``;
* ``api.get_predict_fn`` / ``get_assign_fn``: the callable fetched anew
  (``predict.clear_callables`` first) and called once on 256 / 1,024
  rows.  On the card that call captures the body's CUDA graph (warm-up
  and capture inside ``syncs_allowed``) and replays it once, so the
  census holds the capture's ops and one replay's launches; elsewhere it
  is the eager body;
* ``dist.build_phase[pic]`` / ``dist.swap_iter[pic]`` ->
  ``DistributedBanditPAM``'s ``_Fit.build`` / ``_Fit.swap`` (one SWAP
  iteration) in ``reuse="pic"`` on a one-rank group: ``gloo`` on the
  CPU, ``nccl`` on the card (the process's default group when one of
  world size 1 exists, else one made for the call and destroyed after).

Every launch takes a pinned tile config: :func:`pinned_tiles` makes
``tuning.resolve_tile_config`` return the wave model's pick
(``tuning.heuristic``), so the census never follows the tuner's ledger
(which fits feed with their walls).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import types
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["GraphSpec", "Prepared", "registry", "by_name", "counterpart",
           "pinned_tiles", "N", "D", "K", "B", "WIDTH", "BF", "T"]

# Canonical small shapes: N one step past the 512-row reference tile so
# the streaming walks take more than one tile; every other axis far
# below N, so a materialised [n, n]-class block is plain to GRC002.
N, D, K = 640, 8, 8
B = 32            # bandit batch (reference columns per round)
W_ROUNDS = 2      # PIC ring round capacity at registry shapes
WIDTH = W_ROUNDS * B
BF = 2            # batched multi-fit lane count
T = 3             # batched multi-fit max_swaps
M_STREAM = 64     # candidate rows of the streaming kernels
ROWS_PREDICT, ROWS_ASSIGN = 256, 1024
SEED = 0


@dataclasses.dataclass
class Prepared:
    """One entry point, ready to survey."""

    call: Callable[[], object]
    inputs: Tuple[torch.Tensor, ...] = ()
    # () -> the carried buffers the call must write in place (GRC005),
    # read from their holders before and after the call; None: none
    carried: Optional[Callable[[], Tuple[torch.Tensor, ...]]] = None
    # () -> {collective: count} the port declares for the run it just
    # made (GRC003); None: zero collectives (a single-device entry)
    collectives: Optional[Callable[[], Dict[str, int]]] = None
    cleanup: Optional[Callable[[], None]] = None


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """One registered hot entry point and its declared contracts."""

    name: str
    # (device, backend) -> Prepared
    build: Callable[[torch.device, str], Prepared]
    # {"streaming", "hot", "kernel", "batch", "sharded"}
    tags: frozenset
    # the dataset axis: GRC002 flags any output with >= 2 axes of at
    # least this extent in a "streaming" entry
    n: int = N
    # the port's function, where it differs from the JAX name's
    port: Optional[str] = None
    # audited narrowing float->float casts (GRC006); 0 = none allowed
    allowed_narrowing: int = 0
    # budgets key (GRC001, measured on the card); None = no memory gate
    budget: Optional[str] = None


@contextlib.contextmanager
def pinned_tiles():
    """``tuning.resolve_tile_config`` -> the wave model's pick for the
    shape (``tuning.heuristic``), whatever the ledger holds."""
    from ...core import tuning
    orig = tuning.resolve_tile_config

    def pinned(n, d, k, device_kind=None, backend="torch"):
        return tuning.heuristic(n, d, k, device_kind, backend)

    tuning.resolve_tile_config = pinned
    try:
        yield
    finally:
        tuning.resolve_tile_config = orig


def _points(dev, n=N, d=D, seed=SEED) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _medoids(dev, n=N, k=K, seed=SEED) -> torch.Tensor:
    idx = np.random.default_rng(seed + 1).choice(n, size=k, replace=False)
    return torch.from_numpy(idx.astype(np.int64)).to(dev)


def _bound(dev, backend: str, n: int, d: int = D, k: int = K):
    """The stats backend bound to the (pinned) tiles of an n-row call."""
    from ...core import tuning
    from ...core.engine import bind_stats_backend
    return bind_stats_backend(backend, tuning.resolve_tile_config(
        n, d, k, tuning.current_device_kind(dev), backend))


# -- core drivers -----------------------------------------------------------

def _estimator(dev, backend: str, mode: str, **kw):
    from ...core.banditpam import BanditPAM
    return BanditPAM(K, batch_size=B, reuse=mode, cache_width=WIDTH,
                     backend=backend, device=dev, seed=SEED, **kw)


def _single_fit(dev, backend: str, mode: str, **kw):
    from ...core import rng
    from ...core.report import FitReport
    est = _estimator(dev, backend, mode, **kw)
    x = _points(dev)
    layouts = rng.from_seed(est.seed, dev, est.k)
    res = FitReport(medoids=np.zeros(est.k, np.int64), loss=np.inf)
    ctx = est._make_context(x, backend, layouts, res)
    return est, x, layouts, res, ctx


def _ring_of(ctx):
    return (lambda: (ctx.cache.cols,)) if ctx.mode == "pic" else None


def _build_fused(mode: str):
    def build(dev, backend):
        est, x, layouts, res, ctx = _single_fit(dev, backend, mode)
        ring = _ring_of(ctx)
        return Prepared(
            call=lambda: est._build(x, ctx, layouts, res, True)[1:],
            inputs=(x,), carried=ring)
    return build


def _swap_iter(mode: str):
    def build(dev, backend):
        est, x, layouts, res, ctx = _single_fit(dev, backend, mode,
                                                max_swaps=1)
        medoids, med_t, med_mask = est._build(x, ctx, layouts, res, True)
        ring = _ring_of(ctx)

        def call():
            return est._swap(x, list(medoids), med_t, med_mask.clone(), ctx,
                             layouts, res, True)[1]
        return Prepared(call=call, inputs=(x, med_t), carried=ring)
    return build


def _batch_state(dev, backend: str):
    from ...core import rng
    from ...core.batch import _PicLanes
    from ...core.engine import LaneData
    bp = _estimator(dev, backend, "pic", max_swaps=T)
    lanes = LaneData.pad([_points(dev, seed=SEED + i) for i in range(BF)],
                         dev)
    be = _bound(dev, backend, BF * lanes.n_pad)
    layouts = [rng.from_seed(SEED + i, dev, K) for i in range(BF)]
    pic = _PicLanes(bp, lanes, layouts)
    stats = {"reads": types.SimpleNamespace(host_reads_by_phase={}),
             "rounds": {}}
    return bp, lanes, be, layouts, pic, stats


def _build_batch(dev, backend):
    from ...core.batch import _build_batch as run
    bp, lanes, be, layouts, pic, stats = _batch_state(dev, backend)
    return Prepared(
        call=lambda: run(bp, lanes, be, layouts, stats, pic)[0],
        inputs=(lanes.data,), carried=lambda: (pic.ring.store,))


def _swap_batch(dev, backend):
    from ...core.batch import _build_batch as build_run
    from ...core.batch import _swap_batch as run
    bp, lanes, be, layouts, pic, stats = _batch_state(dev, backend)
    med_t, picks, _, _ = build_run(bp, lanes, be, layouts, stats, pic)
    return Prepared(
        call=lambda: run(bp, lanes, be, layouts, med_t, picks, stats,
                         pic)[1],
        inputs=(lanes.data, med_t), carried=lambda: (pic.ring.store,))


# -- engine streaming helpers ----------------------------------------------

def _engine_fn(name: str):
    def build(dev, backend):
        from ...core import engine
        x, med = _points(dev), _medoids(dev)
        be = _bound(dev, backend, N)
        if name == "total_loss":
            return Prepared(lambda: engine.total_loss(
                x, med, metric="l2", backend=be), (x, med))
        if name == "medoid_cache":
            return Prepared(lambda: engine.medoid_cache(
                x, med, metric="l2", backend=be), (x, med))
        d1, d2, a = engine.medoid_cache(x, med, metric="l2", backend=be)
        if name == "exact_build_means":
            return Prepared(lambda: engine.exact_build_means(
                be, x, d1, metric="l2"), (x, d1))
        return Prepared(lambda: engine.exact_swap_means(
            be, x, d1, d2, a, K, metric="l2"), (x, d1, d2, a))
    return build


# -- the streaming kernels -------------------------------------------------

def _stream_kernel(name: str):
    def build(dev, backend):
        from ...core import engine
        from ...kernels import ops
        y, med = _points(dev), _medoids(dev)
        x = _points(dev, n=M_STREAM, seed=SEED + 7)
        d1, d2, a = engine.medoid_cache(y, med, metric="l2sq",
                                        backend=_bound(dev, backend, N))
        if name == "build":
            return Prepared(lambda: ops.stream_build_g_stats(
                x, y, d1, metric="l2sq"), (x, y, d1))
        if name == "swap":
            return Prepared(lambda: ops.stream_swap_g_stats(
                x, y, d1, d2, a, k=K, metric="l2sq"), (x, y, d1, d2, a))
        pts = y.index_select(0, med)
        return Prepared(lambda: ops.stream_top2(y, pts, metric="l2sq"),
                        (y, pts))
    return build


# -- serving closures -------------------------------------------------------

def _serving(which: str):
    def build(dev, backend):
        from ...api import predict
        rows = ROWS_PREDICT if which == "predict" else ROWS_ASSIGN
        q = _points(dev, n=rows, seed=SEED + 3)
        pts = _points(dev).index_select(0, _medoids(dev))
        predict.clear_callables()
        get = (predict.get_predict_fn if which == "predict"
               else predict.get_assign_fn)

        def call():
            out = get(K, D, "l2", backend, rows, dev)(q, pts)
            # The assign callable returns numpy (labels, dmin).
            return tuple(torch.from_numpy(np.ascontiguousarray(v))
                         if isinstance(v, np.ndarray) else v for v in out)
        return Prepared(call, (q, pts), cleanup=predict.clear_callables)
    return build


# -- sharded phases ---------------------------------------------------------

def _one_rank_group(dev) -> Callable[[], None]:
    """A world-size-1 default group for the call (``gloo`` on the CPU,
    ``nccl`` on the card), or the existing one; returns its cleanup."""
    import torch.distributed as dist
    from ...core.distributed import _free_port
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("the sharded specs run on a one-rank group; "
                               f"this process's has {dist.get_world_size()}")
        return lambda: None
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=120))
    # One all-reduce starts the communicator outside the surveyed call.
    dist.all_reduce(torch.zeros(1, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dist.destroy_process_group


def _dist_phase(which: str):
    def build(dev, backend):
        from ...core import distributed
        from ...core.report import FitReport
        cleanup = _one_rank_group(dev)
        try:
            est = distributed.DistributedBanditPAM(
                K, batch_size=B, reuse="pic", cache_width=WIDTH, seed=SEED,
                backend=backend, device=dev, max_swaps=1)
            x = _points(dev)
            res = FitReport(medoids=np.zeros(K, np.int64), loss=np.inf)
            f = distributed._Fit(est, x, backend, res)
            if which == "build":
                call = f.build
            else:
                med_t, med_mask = f.build()

                def call():
                    f.swap(med_t, med_mask.clone())
                    return med_t
        except BaseException:
            cleanup()
            raise
        base = {}

        def run():
            base.update(distributed.allreduce_counts())
            return call()

        def declared():
            now = distributed.allreduce_counts()
            return {"all_reduce": sum(now.values()) - sum(base.values())}
        return Prepared(run, (x,), carried=lambda: (f.ring.cols,),
                        collectives=declared, cleanup=cleanup)
    return build


# -- the registry -----------------------------------------------------------

_HOT = frozenset({"hot"})
_STREAM = frozenset({"hot", "streaming"})
_KERNEL = frozenset({"hot", "streaming", "kernel"})
_BATCH = frozenset({"hot", "streaming", "batch"})
_SHARDED = frozenset({"hot", "streaming", "sharded"})


def registry() -> Tuple[GraphSpec, ...]:
    """The shipped entry points, one spec for each JAX spec."""
    return (
        GraphSpec("core._build_fused[none]", _build_fused("none"), _STREAM,
                  port="core.BanditPAM._build[none]"),
        GraphSpec("core._build_fused[pic]", _build_fused("pic"), _STREAM,
                  port="core.BanditPAM._build[pic]",
                  budget="core.BanditPAM.build[pic]"),
        GraphSpec("core._swap_iter[none]", _swap_iter("none"), _STREAM,
                  port="core.BanditPAM._swap[none]"),
        GraphSpec("core._swap_iter[pic]", _swap_iter("pic"), _STREAM,
                  port="core.BanditPAM._swap[pic]",
                  budget="core.BanditPAM.swap[pic]"),
        GraphSpec("core._build_batch[pic]", _build_batch, _BATCH,
                  port="core.batch._build_batch[pic]"),
        GraphSpec("core._swap_batch[pic]", _swap_batch, _BATCH,
                  port="core.batch._swap_batch[pic]"),
        GraphSpec("engine.total_loss", _engine_fn("total_loss"), _STREAM,
                  budget="engine.total_loss"),
        GraphSpec("engine.medoid_cache", _engine_fn("medoid_cache"),
                  _STREAM, budget="engine.medoid_cache"),
        GraphSpec("engine.exact_build_means", _engine_fn("exact_build_means"),
                  _STREAM, budget="engine.exact_build_means"),
        GraphSpec("engine.exact_swap_means", _engine_fn("exact_swap_means"),
                  _STREAM, budget="engine.exact_swap_means"),
        GraphSpec("kernels.stream_build_g_stats", _stream_kernel("build"),
                  _KERNEL, port="kernels.ops.stream_build_g_stats",
                  budget="ops.stream_build_g_stats"),
        GraphSpec("kernels.stream_swap_g_stats", _stream_kernel("swap"),
                  _KERNEL, port="kernels.ops.stream_swap_g_stats",
                  budget="ops.stream_swap_g_stats"),
        GraphSpec("kernels.stream_top2", _stream_kernel("top2"), _KERNEL,
                  port="kernels.ops.stream_top2", budget="ops.stream_top2"),
        # get_predict_fn RETURNS the [rows, k] block: materialising it is
        # the product, so no "streaming" tag.
        GraphSpec("api.get_predict_fn", _serving("predict"), _HOT,
                  budget="api.medoid_distances"),
        GraphSpec("api.get_assign_fn", _serving("assign"), _STREAM,
                  budget="api.assign_medoids"),
        GraphSpec("dist.build_phase[pic]", _dist_phase("build"), _SHARDED,
                  port="core.distributed._Fit.build[pic]"),
        GraphSpec("dist.swap_iter[pic]", _dist_phase("swap"), _SHARDED,
                  port="core.distributed._Fit.swap[pic]"),
    )


def by_name() -> Dict[str, GraphSpec]:
    return {s.name: s for s in registry()}


def counterpart(name: str) -> str:
    """The port's function behind the JAX registry name ``name``."""
    spec = by_name()[name]
    return spec.port or name
