"""Out-of-sample inference against fitted medoids (counterpart of
``repro.api.predict``).

* :func:`medoid_distances` — the ``[m, k]`` block through the backend's
  pairwise path (the ``pairwise`` kernel on the card), chunked over the
  query axis so the resident block stays ``chunk × k``; each chunk is
  answered by :func:`get_predict_fn`'s callable for its
  :func:`bucket_rows` bucket (the JAX ``_run_chunks``).
* :func:`assign_medoids` — labels and nearest distances in one top-2
  pass (the ``top2`` kernel on the card); no ``[m, k]`` block.  The
  request is answered by :func:`get_assign_fn`'s callable for its
  :func:`assign_rows` bucket; a request of more than
  :func:`assign_chunk` rows walks that largest bucket in chunks.

Both getters are memoised on their whole key ``(k, d, metric, backend,
rows, device)``, the device normalised first (``None``, ``"cuda"`` and
``"cuda:0"`` are one entry) and at most ``MAX_CALLABLES`` entries each,
the least recently used dropped; ``backend`` is a name
:func:`resolve_backend` already resolved, so ``"auto"`` never aliases to
two entries.  Rows come in power-of-two buckets, so a stream of ragged
request sizes touches at most log2(m) of them.

The kernel backend's callables on a CUDA device (a backend that is a
``CudaStatsBackend`` and a metric in ``KERNEL_METRICS``) each own one
``torch.cuda.CUDAGraph``, captured at the getter's call after a warm-up
on a side stream, over static buffers: the input padded to the bucket
``[rows, d]``, the medoid rows ``[k, d]`` and the outputs.  A call copies
the request into the static input (from a pinned host buffer without
blocking, or device to device for a tensor on the card) and zeroes the
rows a larger request left behind (pad rows are zero and their results
discarded, as in the JAX package), copies the medoid rows into their
buffer (device to device: a service's refit changes them), replays the
graph and copies its outputs out: ``assign``'s labels and ``dmin`` come
back to the host in one copy, as ``[rows, 2]`` int32 words (``dmin``'s
bits), ``predict``'s as new tensors on the card.  The tile shapes are
resolved before the capture, and nothing inside it may wait for the
device: a capture or a replay that fails raises, and there is no eager
path for these backends on the card to fall back to.  The graphs of one
``(k, d, metric, backend, device)`` share one memory pool.  A graph
captured later may hold its outputs in blocks an earlier graph of the
pool frees after each replay, so the pool's calls run one at a time (a
lock, and an event each call waits for on its stream), and every call
copies its outputs out before the next replay.  A replay passes no
Python, so each one adds to the launch counter of every kernel the graph
holds what the capture launched (``kernels.ops.add_launches``); the
warm-up and the capture count nothing.

Every other callable — on the CPU, and for the ``"torch"`` backend, a
registered metric, a callable metric or a user's backend on the card —
is the eager closure on the request's own rows (nothing is padded:
eager PyTorch gains nothing from a fixed shape), under the same key and
cache.
"""

from __future__ import annotations

import functools
import threading
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import tuning
from ..core.device import DeviceLike, resolve_device
from ..core.engine import (CudaStatsBackend, bind_stats_backend,
                           get_stats_backend, host_stage,
                           resolve_stats_backend, syncs_allowed)

DEFAULT_CHUNK = 8192
# The largest assignment bucket holds at most this many floats ([rows,
# d], a power of two of rows up to DEFAULT_CHUNK): a graph's static input
# stays bounded at any request size (32 MB; 8,192 rows at d = 784).
ASSIGN_MAX_ELEMS = 1 << 23
# Callables each getter keeps; past it the least recently used one (its
# graph and static buffers) is dropped.
MAX_CALLABLES = 32
# Warm-up runs of a body on a side stream before its capture (PyTorch's
# recipe: lazy initialisation, e.g. a cuBLAS workspace, stays out of the
# graph).
WARMUP_RUNS = 3


def resolve_backend(backend: Optional[str], metric: str,
                    device: torch.device) -> str:
    """A predict ``backend`` as a registered stats-backend name; unknown
    names raise ``ValueError`` as in the JAX package."""
    try:
        return resolve_stats_backend(backend, metric, device)
    except KeyError as e:
        raise ValueError(f"unknown predict backend {backend!r}; "
                         f"{e.args[0] if e.args else e}") from None


def bucket_rows(m: int, chunk: int) -> int:
    """Fixed-shape row bucket for an ``m``-row request: the smallest
    power of two >= m, clamped to ``chunk``."""
    m = min(max(1, m), chunk)
    return min(1 << (m - 1).bit_length(), chunk)


def assign_rows(m: int) -> int:
    """Row bucket for the assignment path: the smallest power of two >=
    m (the JAX function; :func:`assign_medoids` never asks it for more
    than :func:`assign_chunk` rows)."""
    return 1 << (max(1, m) - 1).bit_length()


def assign_chunk(d: int) -> int:
    """The largest assignment bucket at width ``d``: the largest power of
    two of rows, at most ``DEFAULT_CHUNK``, whose ``[rows, d]`` input
    holds at most ``ASSIGN_MAX_ELEMS`` floats."""
    cap = max(1, ASSIGN_MAX_ELEMS // max(1, d))
    return min(DEFAULT_CHUNK, 1 << (cap.bit_length() - 1))


def _device_key(device) -> torch.device:
    """``device`` with its index, so that ``"cuda"`` and ``"cuda:0"`` name
    one cache entry."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _predict_body(be, metric: str):
    def body(xp, med):
        dmat = be.pairwise(xp, med, metric=metric)
        labels = torch.argmin(dmat, dim=1).to(torch.int32)
        return dmat, labels, torch.amin(dmat, dim=1)
    return body


def _assign_body(be, metric: str):
    def body(xp, med):
        d1, _, labels = be.top2(xp, med, metric=metric)
        # Labels and dmin as [rows, 2] int32 words (dmin's bits): a
        # request's m rows are one contiguous block, read in one copy.
        return torch.stack([labels.to(torch.int32), d1.view(torch.int32)],
                           dim=1)
    return body


def _words(host: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``[m, 2]`` int32 words as (labels int32, dmin float32)."""
    return (np.ascontiguousarray(host[:, 0]),
            np.ascontiguousarray(host[:, 1]).view(np.float32))


class _EagerFn:
    """The eager callable: the body on the request's own rows."""

    def __init__(self, body, rows: int, device: torch.device, read: bool):
        self.rows, self.device = rows, device
        self._body, self._read = body, read

    def __call__(self, x, med):
        with host_stage("the queries"):
            q = torch.as_tensor(x, dtype=torch.float32).to(
                self.device).contiguous()
        out = self._body(q, med.to(self.device, torch.float32))
        if self._read:
            with syncs_allowed(self.device):
                return _words(out.cpu().numpy())
        return out


class _Pool:
    """The memory pool of the graphs of one (k, d, metric, backend,
    device), and what makes their calls run one at a time: a lock, and
    the event of the last call's end, which the next call's stream waits
    for."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()


class _GraphFn:
    """The kernel backend's callable on the card: one CUDA graph of the
    body over static buffers (module docstring)."""

    def __init__(self, body, rows: int, d: int, k: int, device: torch.device,
                 pool: _Pool, read: bool):
        self.rows, self.d, self.device = rows, d, device
        self._read, self._pool = read, pool
        self._x = torch.zeros((rows, d), dtype=torch.float32, device=device)
        self._med = torch.zeros((k, d), dtype=torch.float32, device=device)
        self._host: Optional[torch.Tensor] = None   # pinned, at first use
        self._uploaded = torch.cuda.Event()          # the last upload's end
        self._dirty = 0          # static input rows that may be non-zero
        self.replays = 0
        self.held: dict = {}
        with pool.lock, torch.cuda.device(device), syncs_allowed(device):
            self._capture(body)

    def _capture(self, body) -> None:
        """Warm up on a side stream, then capture; the warm-up's and the
        capture's launches leave the counters as they were."""
        from ..kernels import ops
        before = ops.launch_counts()
        try:
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    body(self._x, self._med)
            cur.wait_stream(side)
            mid = ops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=self._pool.handle):
                self._out = body(self._x, self._med)
            after = ops.launch_counts()
            self.held = {nm: after[nm] - mid[nm] for nm in after
                         if after[nm] != mid[nm]}
        finally:
            ops.reset_launch_counts()
            ops.add_launches(before)

    def _stage(self, x) -> int:
        """The request into the static input's first m rows; the rows a
        larger request left there are zeroed."""
        m = x.shape[0]
        if isinstance(x, torch.Tensor) and x.is_cuda:
            self._x[:m].copy_(x)
        else:
            if self._host is None:
                self._host = torch.empty((self.rows, self.d),
                                         dtype=torch.float32, pin_memory=True)
            # The last call's upload may still read the buffer (an event
            # never recorded reads as done).
            self._uploaded.synchronize()
            if isinstance(x, torch.Tensor):
                self._host[:m].copy_(x)
            else:
                self._host.numpy()[:m] = x
            self._x[:m].copy_(self._host[:m], non_blocking=True)
            self._uploaded.record()
        if self._dirty > m:
            self._x[m:self._dirty].zero_()
        self._dirty = m
        return m

    def __call__(self, x, med):
        from ..kernels import ops
        pool = self._pool
        with pool.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            stream.wait_event(pool.done)
            m = self._stage(x)
            self._med.copy_(med)
            self.graph.replay()
            self.replays += 1
            ops.add_launches(self.held)
            if self._read:
                with syncs_allowed(self.device):
                    out = _words(self._out[:m].cpu().numpy())
            else:
                out = tuple(t[:m].clone() for t in self._out)
            pool.done.record(stream)
            return out


@functools.lru_cache(maxsize=None)
def _graph_pool(k: int, d: int, metric: str, backend: str,
                device: torch.device) -> _Pool:
    return _Pool()


def _captured(backend: str, metric, device: torch.device) -> bool:
    """Whether a callable replays a graph: the kernel backend's kernel
    metrics on a CUDA device."""
    from ..kernels.ops import KERNEL_METRICS
    return (device.type == "cuda" and metric in KERNEL_METRICS
            and isinstance(get_stats_backend(backend), CudaStatsBackend))


def _make_fn(body_of, read: bool, k: int, d: int, metric: str, backend: str,
             rows: int, dev: torch.device) -> Callable:
    if not _captured(backend, metric, dev):
        return _EagerFn(body_of(get_stats_backend(backend), metric), rows,
                        dev, read)
    # The kernels' tiles are resolved here, outside the capture.
    tiles = tuning.resolve_tile_config(rows, d, k,
                                       tuning.current_device_kind(dev),
                                       "cuda")
    body = body_of(bind_stats_backend(backend, tiles), metric)
    return _GraphFn(body, rows, d, k, dev,
                    _graph_pool(k, d, metric, backend, dev), read)


def _keyed_on_device(make):
    """``make`` memoised on its whole key, the device normalised first
    (:func:`resolve_device`, then :func:`_device_key`), at most
    ``MAX_CALLABLES`` entries; ``cache_info`` / ``cache_clear`` are the
    cache's."""
    cached = functools.lru_cache(maxsize=MAX_CALLABLES)(make)

    @functools.wraps(make)
    def get(k: int, d: int, metric: str, backend: str, rows: int,
            device: DeviceLike = None):
        return cached(k, d, metric, backend, rows,
                      _device_key(resolve_device(device)))
    get.cache_info, get.cache_clear = cached.cache_info, cached.cache_clear
    return get


@_keyed_on_device
def get_predict_fn(k: int, d: int, metric: str, backend: str, rows: int,
                   device: DeviceLike = None):
    """``(x [m, d], med [k, d]) -> (dist [m, k], labels [m] int32,
    dmin [m])``, new tensors on ``device``, for any ``m <= rows``.
    Memoised on its full key; ``backend`` must be resolved
    (:func:`resolve_backend`).  The kernel backend's callable on a CUDA
    device pads the request to ``rows`` and replays its CUDA graph; the
    others run eagerly (module docstring)."""
    return _make_fn(_predict_body, False, k, d, metric, backend, rows,
                    device)


@_keyed_on_device
def get_assign_fn(k: int, d: int, metric: str, backend: str, rows: int,
                  device: DeviceLike = None):
    """``(x [m, d], med [k, d]) -> (labels [m] int32, dmin [m] float32)``
    as numpy, for any ``m <= rows``, through the backend's top-2 pass;
    memoised and routed as :func:`get_predict_fn`.  The graph's callable
    reads both outputs in one copy."""
    return _make_fn(_assign_body, True, k, d, metric, backend, rows, device)


def clear_callables() -> None:
    """Drop every cached callable (their graphs and static buffers)."""
    get_predict_fn.cache_clear()
    get_assign_fn.cache_clear()


def _as_queries(x, d: int):
    """Queries as a 2-D float32 numpy array or a tensor (cast where it is
    copied), ``[m, d]``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"expected [m, {d}] queries, got shape "
                         f"{tuple(x.shape)}")
    return x


def _medoid_points(points, device: torch.device) -> torch.Tensor:
    with host_stage("the medoid points"):
        return torch.as_tensor(points, dtype=torch.float32).to(
            device).contiguous()


def medoid_distances_t(x, medoid_points: torch.Tensor, metric: str, *,
                       backend: Optional[str] = None,
                       chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """``[m, d]`` queries × ``[k, d]`` medoid rows → ``[m, k]`` float32,
    a tensor on the medoid rows' device; each chunk of at most ``chunk``
    rows is one call of its bucket's :func:`get_predict_fn` callable."""
    dev = _device_key(medoid_points.device)
    bname = resolve_backend(backend, metric, dev)
    k, d = int(medoid_points.shape[0]), int(medoid_points.shape[1])
    x = _as_queries(x, d)
    chunk = max(1, int(chunk))
    m = x.shape[0]
    if 0 < m <= chunk:       # one chunk: its callable's tensor is the result
        return get_predict_fn(k, d, metric, bname, bucket_rows(m, chunk),
                              dev)(x, medoid_points)[0]
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    for lo in range(0, m, chunk):
        m_c = min(chunk, m - lo)
        fn = get_predict_fn(k, d, metric, bname, bucket_rows(m_c, chunk), dev)
        out[lo:lo + m_c] = fn(x[lo:lo + m_c], medoid_points)[0]
    return out


def medoid_distances(x, medoid_points, metric: str, *,
                     backend: Optional[str] = None,
                     chunk: int = DEFAULT_CHUNK,
                     device: DeviceLike = None) -> np.ndarray:
    """``[m, d]`` queries × ``[k, d]`` fitted medoids → ``[m, k]`` numpy
    float32.  ``device=None`` means the card."""
    med = _medoid_points(medoid_points, resolve_device(device))
    return medoid_distances_t(x, med, metric, backend=backend,
                              chunk=chunk).cpu().numpy()


# One warning a process, not a request: serving loops call this hot.
_chunk_deprecation_warned = False


def assign_medoids(x, medoid_points, metric: str, *,
                   backend: Optional[str] = None,
                   chunk: Optional[int] = None,
                   device: DeviceLike = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``[m, d]`` queries → ``(labels [m] int32, dmin [m] float32)`` in
    one top-2 pass and one read; ties go to the lowest medoid index.  A
    request of more than :func:`assign_chunk` rows takes one pass and one
    read a chunk of that many.

    .. deprecated::
        ``chunk`` is ignored (the top-2 pass holds one row tile resident
        at any m), as in the JAX package; passing it warns with a
        ``DeprecationWarning`` once a process.
    """
    global _chunk_deprecation_warned
    if chunk is not None and not _chunk_deprecation_warned:
        _chunk_deprecation_warned = True
        warnings.warn(
            "assign_medoids(chunk=...) is deprecated and ignored: the "
            "top-2 pass needs no query chunking. The parameter will be "
            "removed in a future release.", DeprecationWarning, stacklevel=2)
    dev = _device_key(resolve_device(device))
    med = _medoid_points(medoid_points, dev)
    bname = resolve_backend(backend, metric, dev)
    k, d = int(med.shape[0]), int(med.shape[1])
    x = _as_queries(x, d)
    m, step = x.shape[0], assign_chunk(d)
    if m <= step:
        if m == 0:
            return np.empty((0,), np.int32), np.empty((0,), np.float32)
        return get_assign_fn(k, d, metric, bname, assign_rows(m), dev)(x, med)
    labels, dmin = np.empty((m,), np.int32), np.empty((m,), np.float32)
    for lo in range(0, m, step):
        m_c = min(step, m - lo)
        fn = get_assign_fn(k, d, metric, bname, assign_rows(m_c), dev)
        labels[lo:lo + m_c], dmin[lo:lo + m_c] = fn(x[lo:lo + m_c], med)
    return labels, dmin
