"""The streaming kernels: top-2, and the exact BUILD / SWAP statistics.

* ``top2`` replaces the TPU kernel ``src/repro/kernels/stream_g.py:165``
  (``stream_top2_kernel``) with the CUDA kernel ``csrc/stream_g.cu``.  In
  the port it carries the SWAP loop's medoid cache and candidate loss and
  the fit's labels as well as assignment, for any k >= 1.  On the H100
  it is memory-bound at the default k (n=60000, k=10, d=784: 0.94 GFLOP
  against 188 MB of x, about 56 us) and compute-bound from k of about
  40 (k=200: 0.28 ms).  The design runs the distance mainloop
  (``csrc/dist_mainloop.cuh``) in a tile chosen by k in
  ``repro_torch.core.tuning`` (``top2_tile``: 64 x 16 up to 16 medoids;
  beyond, 128 rows by 40, 72 or 104 columns, whichever walk of column
  tiles is shortest, in index order with x's rows fixed); each
  thread scans its columns in
  index order and the threads of a row merge their (best, index,
  second) triples lexicographically, which is the sequential scan's
  answer, so the first-index tie rule holds and the [n, k] block never
  reaches device memory.
* ``stream_build_g`` and ``stream_swap_g`` replace the TPU kernels
  ``src/repro/kernels/stream_g.py:65`` (``stream_build_g_kernel``) and
  ``:115`` (``stream_swap_g_kernel``) with the CUDA kernels of
  ``csrc/stream_stats.cu`` and ``csrc/swap_g.cu``: build_g's and
  swap_g's statistics over the WHOLE reference set (r unbounded),
  walked in 512-column tiles whose sums are added in walk order.  They
  carry the exact passes: the replacement-sampling fallback and every
  step of PAM.  At m = r = 60,000, d = 784 a pass is 2·m·r·d = 5.6 TFLOP
  of float32 distance work against 376 MB of reads: compute-bound,
  84 ms at 67 TFLOP/s.
  Both run build_g's pipelined mainloop (``csrc/dist_mainloop.cuh``)
  over each 512-column tile in 104-column steps, in the row tile the
  tuner resolved; ``stream_swap_g`` is ``csrc/swap_g.cu``'s kernel with
  that walk and takes any k >= 1.

Every launch goes to the kernel's ``_tiled`` C entry with the shape
index ``repro_torch.core.tuning`` resolved (``ops`` picks it).

The lane axis (``fit_batch``): ``launch_top2_lanes`` runs the top-2
kernel over L padded fits ``[L, n_pad, d]`` against their own medoids
``[L, k, d]`` in one launch (``rt_top2_lanes``), each lane with its row
count, into ``[L, n_pad]``; lane l gets the bits of a single launch on
its own slice.  ``top2_lanes_torch`` is its plain version (a loop of
``top2_torch``) and ``top2_lane_launches`` its counter.

Each kernel has its plain version here (``top2_torch``,
``stream_build_g_torch``, ``stream_swap_g_torch``: the engine's walks)
and its own launch counter (``top2_launches``,
``stream_build_launches``, ``stream_swap_launches``).
"""

from __future__ import annotations

import torch

from ..core.engine import (_stream_build_stats, _stream_swap_stats,
                           _stream_top2)
from ..core.tuning import REF_TILE
from . import build as _build
from .pairwise import METRIC_IDS, lane_rows
from .swap_g import bin_scratch

top2_launches = 0
top2_lane_launches = 0
stream_build_launches = 0
stream_swap_launches = 0


def top2_torch(x, med, metric: str):
    """Plain version: ``(d1, d2, assign int32)``, ``[n]`` each, one
    ``[512, k]`` block at a time (``engine._stream_top2``)."""
    return _stream_top2(x, med, metric)


def stream_build_g_torch(x, yref, dnear, w, lead_g, metric: str, run=None):
    """Plain version: ``(Σg, Σg², Σg·g_lead)`` over all of ``yref``,
    ``[m]`` each, walked in 512-column tiles (tail padded at weight 0)
    added in walk order (``engine._stream_build_stats``), whatever the
    run flag says."""
    return _stream_build_stats(x, yref, dnear, w, lead_g, metric)


def stream_swap_g_torch(x, yref, d1, d2, assign, w, k: int, lead_g,
                        metric: str, run=None):
    """Plain version: ``(Σg, Σg², Σg·g_lead)`` over all of ``yref``,
    ``[k, m]`` each, the same walk (``engine._stream_swap_stats``),
    whatever the run flag says."""
    return _stream_swap_stats(x, yref, d1, d2, assign, w, k, lead_g, metric)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_top2(x, med, metric: str, *, shape: int):
    """Run the top-2 kernel on validated CUDA tensors (see ``ops``)."""
    global top2_launches
    n, d = x.shape
    k = med.shape[0]
    d1 = torch.empty((n,), dtype=torch.float32, device=x.device)
    d2 = torch.empty_like(d1)
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    code = _build.lib().rt_top2_tiled(
        x.data_ptr(), med.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        assign.data_ptr(), n, k, d, METRIC_IDS[metric], shape, _stream(x))
    top2_launches += 1
    _build.check(code, "top2 kernel")
    return d1, d2, assign


def launch_stream_build(x, yref, dnear, w, lead_g, metric: str, run=None,
                        *, shape: int):
    """Run the streaming BUILD kernel on validated CUDA tensors; a run
    flag that reads 0 leaves the outputs unwritten."""
    global stream_build_launches
    m, d = x.shape
    r = yref.shape[0]
    sums, sq, cross = (torch.empty((m,), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
    code = _build.lib().rt_stream_build_g_tiled(
        x.data_ptr(), yref.data_ptr(), dnear.data_ptr(), w.data_ptr(),
        lead_g.data_ptr(), sums.data_ptr(), sq.data_ptr(), cross.data_ptr(),
        m, r, d, METRIC_IDS[metric], None if run is None else run.data_ptr(),
        shape, _stream(x))
    stream_build_launches += 1
    _build.check(code, "stream_build_g kernel")
    return sums, sq, cross


def launch_stream_swap(x, yref, d1, d2, assign, w, k: int, lead_g,
                       metric: str, run=None, *, shape: int,
                       moments: bool = True):
    """Run the streaming SWAP kernel on validated CUDA tensors; a run flag
    that reads 0 leaves the outputs unwritten.  ``moments=False`` writes
    the sums alone (the exact pass's mean) and returns None for Σg² and
    Σg·g_lead."""
    global stream_swap_launches
    m, d = x.shape
    r = yref.shape[0]
    sums, sq, cross = (torch.empty((k, m), dtype=torch.float32,
                                   device=x.device)
                       if moments or i == 0 else None for i in range(3))
    scratch, floats = bin_scratch(x.device, m, r, k, REF_TILE, metric, 1,
                                  shape)
    ptr = (lambda t: None if t is None else t.data_ptr())
    code = _build.lib().rt_stream_swap_g_tiled(
        x.data_ptr(), yref.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        assign.data_ptr(), w.data_ptr(), lead_g.data_ptr(), sums.data_ptr(),
        ptr(sq), ptr(cross), m, r, d, k, METRIC_IDS[metric], ptr(run),
        ptr(scratch), floats, shape, _stream(x))
    stream_swap_launches += 1
    _build.check(code, "stream_swap_g kernel")
    return sums, sq, cross


def top2_lanes_torch(x, med, rows, metric: str):
    """Plain version of the lane kernel: ``top2_torch`` on each lane's
    ``[rows[l], d]`` slice against its medoids, into ``[L, n_pad]`` zeros
    (assign int32)."""
    lanes, n_pad = x.shape[0], x.shape[1]
    d1 = torch.zeros((lanes, n_pad), dtype=torch.float32, device=x.device)
    d2 = torch.zeros_like(d1)
    assign = torch.zeros((lanes, n_pad), dtype=torch.int32, device=x.device)
    # tracecheck: ignore[TRC002] -- the plain lane version (CPU tensors only):
    # the single form once a lane
    for i, n in enumerate(lane_rows(rows, lanes, n_pad)):
        if n:
            d1[i, :n], d2[i, :n], assign[i, :n] = top2_torch(x[i, :n], med[i],
                                                             metric)
    return d1, d2, assign


def launch_top2_lanes(x, med, rows, metric: str, *, shape: int):
    """Run the lane top-2 kernel on validated CUDA tensors (see ``ops``):
    outputs ``[L, n_pad]``, unwritten past each lane's rows."""
    global top2_lane_launches
    lanes, n_pad, d = x.shape
    k = med.shape[1]
    d1 = torch.empty((lanes, n_pad), dtype=torch.float32, device=x.device)
    d2 = torch.empty_like(d1)
    assign = torch.empty((lanes, n_pad), dtype=torch.int32, device=x.device)
    code = _build.lib().rt_top2_lanes_tiled(
        x.data_ptr(), med.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        assign.data_ptr(), lanes, n_pad, k, d, METRIC_IDS[metric],
        None if rows is None else rows.data_ptr(), shape, _stream(x))
    top2_lane_launches += 1
    _build.check(code, "top2 lane kernel")
    return d1, d2, assign
