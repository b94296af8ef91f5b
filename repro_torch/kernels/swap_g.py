"""Fused SWAP (FastPAM1) arm statistics for all k medoid-arms at once.

Two CUDA kernels over the shared column routine and fold of
``csrc/swap_tile.cuh`` (the TPU kernels' ``swap_stats_vals``,
``src/repro/kernels/swap_g.py:40``):

* ``swap_g`` replaces ``swap_g_kernel`` (``:85``): the distances of the
  batch computed in the kernel from the points, on build_g's pipelined
  mainloop (``csrc/swap_g.cu``, which also carries ``stream_swap_g``:
  the batch is one reference tile of that walk, so the two give equal
  bits at r = B <= 512).  Its bound is build_g's: the distance work,
  compute-bound at the main path's shapes.
* ``swap_g_from_cache`` replaces ``swap_g_from_cache_kernel``
  (``:118``): the same statistics read from a resident ``[m, B]`` block
  of the PIC column ring (one round's slice, or the whole ring in the
  carried-moment repair), with no distance work
  (``csrc/swap_g_from_cache.cu``).  It takes any row stride, so a
  column slice of the ring is read in place, walks any B (the TPU
  wrapper's ``CACHE_B_MAX`` chunking is a VMEM limit the card does not
  have) and reads only the weighted columns.  Its bound is its bytes.

Given equal distances the two give equal bits (one column routine, one
owner order, one fold).  The TPU kernels' one-hot ``[B, K]`` matrix
product becomes a binned add chosen by each reference point's cluster:
the same function with k times less work, no atomics, and the ``[k, m]``
engine layout written directly.  Both take any k >= 1: past 32 clusters
the bins are held a chunk of 32 at a time.

``swap_g_torch`` and ``swap_g_from_cache_torch`` are the plain versions
(the engine's one-hot form).  ``launches`` and ``cached_launches`` count
the two kernels' launches.

The lane axis (``fit_batch``): ``launch_lanes`` runs ``swap_g``'s kernel
over L padded fits ``[L, n_pad, d]`` in one launch (``rt_swap_g_lanes``),
each lane with its own batch, medoid cache slice, run flag and row count,
into ``[L, k, n_pad]``; lane l gets the bits of a single launch on its
own slice.  ``swap_g_lanes_torch``, its plain version, loops over the
lanes with ``swap_g_torch``; ``lane_launches`` counts its launches.
``launch_cached_lanes`` does the same for ``swap_g_from_cache``
(``rt_swap_g_from_cache_lanes``, the PIC batch): each lane reads its own
resident block at its own column offset of a lane ring ``[L, n_pad, C]``
(a round's slot, a recycled round's scratch columns, or the whole ring
in the carried-moment repair); ``swap_g_from_cache_lanes_torch`` loops
``swap_g_from_cache_torch`` and ``cached_lane_launches`` counts it.

The bin scratch.  Where a launch's reference tile spans more than one
104-column tile (``stream_swap_g``; ``swap_g`` at B > 104) the kernel
carries its bins between column tiles in a global scratch of
lanes x grid x BM x 4 x 3 x k floats (grid: at most one block a
resident slot).  :func:`bin_scratch` allocates it with PyTorch's
allocator on the launch's stream, at the size the library's
``rt_swap_g_scratch`` gives, so ``torch.cuda.max_memory_allocated``
counts it and the library itself allocates no device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.distances import pairwise
from ..core.engine import _swap_batch_stats
from . import build as _build
from .pairwise import METRIC_IDS, host_ints, lane_rows

launches = 0
cached_launches = 0
lane_launches = 0
cached_lane_launches = 0


def swap_g_torch(x, y, d1_b, d2_b, assign_b, w, k: int, lead_g,
                 metric: str, run=None):
    """Plain version: ``(Σg, Σg², Σg·g_lead)``, each ``[k, m]``, computed
    whatever the run flag says (the caller discards a masked round's)."""
    return _swap_batch_stats(pairwise(x, y, metric=metric), d1_b, d2_b,
                             assign_b, w, k, lead_g)


def swap_g_from_cache_torch(dxy, d1_b, d2_b, assign_b, w, k: int, lead_g,
                            run=None):
    """Plain version of the cached kernel: ``(Σg, Σg², Σg·g_lead)`` of a
    given ``[m, B]`` distance block, each ``[k, m]``, computed whatever
    the run flag says."""
    return _swap_batch_stats(dxy, d1_b, d2_b, assign_b, w, k, lead_g)


@functools.lru_cache(maxsize=256)
def _scratch_floats(card: int, m: int, r: int, k: int, period: int,
                    metric_id: int, lanes: int, shape: int) -> int:
    # ``card`` (the current device) keys the occupancy the size rests on.
    out = ctypes.c_int64(0)
    _build.check(_build.lib().rt_swap_g_scratch(
        m, r, k, period, metric_id, lanes, shape, ctypes.byref(out)),
        "swap_g scratch query")
    return out.value


def bin_scratch(device: torch.device, m: int, r: int, k: int, period: int,
                metric: str, lanes: int, shape: int
                ) -> Tuple[Optional[torch.Tensor], int]:
    """The swap_g kernel's bin scratch for one launch (m rows a lane, r
    reference rows in tiles of ``period``) and its size in floats, on
    ``device`` from PyTorch's allocator; ``(None, 0)`` where the launch
    needs none."""
    floats = _scratch_floats(torch.cuda.current_device(), int(m), int(r),
                             int(k), int(period), METRIC_IDS[metric],
                             int(lanes), int(shape))
    if floats == 0:
        return None, 0
    return torch.empty((floats,), dtype=torch.float32, device=device), floats


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(x, y, d1_b, d2_b, assign_b, w, k: int, lead_g, metric: str,
           run=None, *, shape: int):
    """Run the CUDA kernel on validated CUDA tensors (see ``ops``); a run
    flag ``run`` ([1] int32) that reads 0 leaves the outputs unwritten
    (counted as a launch all the same)."""
    global launches
    m, d = x.shape
    b = y.shape[0]
    sums, sq, cross = (torch.empty((k, m), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
    scratch, floats = bin_scratch(x.device, m, b, k, b, metric, 1, shape)
    code = _build.lib().rt_swap_g_tiled(
        x.data_ptr(), y.data_ptr(), d1_b.data_ptr(), d2_b.data_ptr(),
        assign_b.data_ptr(), w.data_ptr(), lead_g.data_ptr(),
        sums.data_ptr(), sq.data_ptr(), cross.data_ptr(), m, b, d, k,
        METRIC_IDS[metric], _ptr(run), _ptr(scratch), floats,
        shape, torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    _build.check(code, "swap_g kernel")
    return sums, sq, cross


def launch_cached(dxy, d1_b, d2_b, assign_b, w, k: int, lead_g, run=None,
                  *, shape: int):
    """Run the cached kernel on validated CUDA tensors (see ``ops``):
    ``dxy`` [m, B] with unit column stride and any row stride; a run flag
    that reads 0 leaves the outputs unwritten."""
    global cached_launches
    m, b = dxy.shape
    ld = dxy.stride(0) if m > 1 else b
    sums, sq, cross = (torch.empty((k, m), dtype=torch.float32,
                                   device=dxy.device) for _ in range(3))
    code = _build.lib().rt_swap_g_from_cache_tiled(
        dxy.data_ptr(), ld, d1_b.data_ptr(), d2_b.data_ptr(),
        assign_b.data_ptr(), w.data_ptr(), lead_g.data_ptr(),
        sums.data_ptr(), sq.data_ptr(), cross.data_ptr(), m, b, k,
        None if run is None else run.data_ptr(),
        shape, torch.cuda.current_stream(dxy.device).cuda_stream)
    cached_launches += 1
    _build.check(code, "swap_g_from_cache kernel")
    return sums, sq, cross


def swap_g_lanes_torch(x, y, d1_b, d2_b, assign_b, w, k: int, lead_g, rows,
                       metric: str, run=None):
    """Plain version of the lane kernel: ``swap_g_torch`` on each lane's
    ``[rows[l], d]`` slice, into ``[L, k, n_pad]`` zeros; every lane is
    computed whatever its flag."""
    lanes, n_pad = x.shape[0], x.shape[1]
    outs = [torch.zeros((lanes, k, n_pad), dtype=torch.float32,
                        device=x.device) for _ in range(3)]
    # tracecheck: ignore[TRC002] -- the plain lane version (CPU tensors only):
    # the single form once a lane
    for i, n in enumerate(lane_rows(rows, lanes, n_pad)):
        part = swap_g_torch(x[i, :n], y[i], d1_b[i], d2_b[i], assign_b[i],
                            w[i], k, lead_g[i], metric)
        # tracecheck: ignore[TRC002] -- the three outputs
        for o, v in zip(outs, part):
            o[i, :, :n] = v
    return tuple(outs)


def launch_lanes(x, y, d1_b, d2_b, assign_b, w, k: int, lead_g, rows,
                 metric: str, run=None, *, shape: int):
    """Run the lane kernel on validated CUDA tensors (see ``ops``):
    outputs ``[L, k, n_pad]``, unwritten past each lane's rows and in
    every lane whose run flag reads 0."""
    global lane_launches
    lanes, n_pad, d = x.shape
    b = y.shape[1]
    sums, sq, cross = (torch.empty((lanes, k, n_pad), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
    scratch, floats = bin_scratch(x.device, n_pad, b, k, b, metric, lanes,
                                  shape)
    code = _build.lib().rt_swap_g_lanes_tiled(
        x.data_ptr(), y.data_ptr(), d1_b.data_ptr(), d2_b.data_ptr(),
        assign_b.data_ptr(), w.data_ptr(), lead_g.data_ptr(),
        sums.data_ptr(), sq.data_ptr(), cross.data_ptr(), lanes, n_pad, b, d,
        k, METRIC_IDS[metric], _ptr(rows), _ptr(run), _ptr(scratch), floats,
        shape, torch.cuda.current_stream(x.device).cuda_stream)
    lane_launches += 1
    _build.check(code, "swap_g lane kernel")
    return sums, sq, cross


def swap_g_from_cache_lanes_torch(dxy, d1_b, d2_b, assign_b, w, k: int,
                                  lead_g, col, rows, run=None):
    """Plain version of the cached lane kernel: ``swap_g_from_cache_torch``
    on each lane's block ``dxy[l, :rows[l], col[l]:col[l] + B]``, into
    ``[L, k, n_pad]`` zeros; every lane is computed whatever its flag."""
    lanes, n_pad = dxy.shape[0], dxy.shape[1]
    b = d1_b.shape[1]
    cols = [0] * lanes if col is None else host_ints(col)
    outs = [torch.zeros((lanes, k, n_pad), dtype=torch.float32,
                        device=dxy.device) for _ in range(3)]
    # tracecheck: ignore[TRC002] -- the plain lane version (CPU tensors only):
    # the single form once a lane
    for i, n in enumerate(lane_rows(rows, lanes, n_pad)):
        part = swap_g_from_cache_torch(dxy[i, :n, cols[i]:cols[i] + b],
                                       d1_b[i], d2_b[i], assign_b[i], w[i], k,
                                       lead_g[i])
        # tracecheck: ignore[TRC002] -- the three outputs
        for o, v in zip(outs, part):
            o[i, :, :n] = v
    return tuple(outs)


def launch_cached_lanes(dxy, d1_b, d2_b, assign_b, w, k: int, lead_g, col,
                        rows, run=None, *, shape: int):
    """Run the cached lane kernel on validated CUDA tensors (see ``ops``):
    ``dxy`` ``[L, n_pad, C]`` with unit column stride, lane l's block at
    columns ``[col[l], col[l] + B)``; outputs ``[L, k, n_pad]``, unwritten
    past each lane's rows and in every lane whose run flag reads 0."""
    global cached_lane_launches
    lanes, n_pad = dxy.shape[0], dxy.shape[1]
    b = d1_b.shape[1]
    ld = dxy.stride(1) if n_pad > 1 else dxy.shape[2]
    sums, sq, cross = (torch.empty((lanes, k, n_pad), dtype=torch.float32,
                                   device=dxy.device) for _ in range(3))
    code = _build.lib().rt_swap_g_from_cache_lanes_tiled(
        dxy.data_ptr(), dxy.stride(0), ld,
        None if col is None else col.data_ptr(), d1_b.data_ptr(),
        d2_b.data_ptr(), assign_b.data_ptr(), w.data_ptr(), lead_g.data_ptr(),
        sums.data_ptr(), sq.data_ptr(), cross.data_ptr(), lanes, n_pad, b, k,
        None if rows is None else rows.data_ptr(),
        None if run is None else run.data_ptr(),
        shape, torch.cuda.current_stream(dxy.device).cuda_stream)
    cached_lane_launches += 1
    _build.check(code, "swap_g_from_cache lane kernel")
    return sums, sq, cross
