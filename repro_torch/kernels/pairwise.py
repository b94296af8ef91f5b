"""Pairwise dissimilarity ``[m, d] x [r, d] -> [m, r]``.

Replaces the TPU kernel ``src/repro/kernels/pairwise.py:74``
(``pairwise_kernel``, body ``dist_tile`` at ``:34``) with the CUDA kernel
``csrc/pairwise.cu`` over the pipelined, register-blocked mainloop
``csrc/dist_mainloop.cuh``, which gives every pair the bits of
``csrc/dist_math.cuh`` that every distance kernel shares.  On the
H100 it is memory-bound at the predict shapes (queries against k medoid
columns: x is read once, the [m, k] block written once) and
compute-bound once r is large; the design (wide tiles of 128, 64 or 32
rows by 104 or 128 columns, a 64 x 16 tile for r <= 16 and, with the
operands swapped, for m <= 16; a cp.async feature ring; coalesced
stores from a shared-memory tile) is described in the sources.  Every
launch takes the shape index ``repro_torch.core.tuning`` resolved
(``rt_pairwise_tiled``; a pair's bits do not depend on it).  There is
no feature-axis split (the TPU kernel's ``DK_MAX``): the mainloop loops
over any d.

The kernel writes into a given output of any row stride (a PIC round's
slot of the column ring, ``cols[:, s:s+B]``) and takes a run flag: where
it reads 0 the output is left as it was.

The lane axis (the PIC ``fit_batch``): ``launch_lanes`` runs the same
kernel over L problems ``[L, m, d] x [L, r, d]`` in one launch
(``rt_pairwise_lanes``), each lane with its own row counts, run flag and
output column offset, so one launch writes every lane's fresh PIC block
into its ring slot (or a recycled round's scratch columns) and computes
every lane's ``d_near`` row; lane l gets the bits of a single launch on
its own slices.

``pairwise_torch`` is the plain version: the registry metric of
``repro_torch.core.distances``; ``pairwise_plain`` gives it the
kernel's ``out`` / ``run`` contract, and ``pairwise_lanes_plain`` loops
it over the lanes.  ``launches`` and ``lane_launches`` count the two
entry points' launches.
"""

from __future__ import annotations

import torch

from ..core.distances import pairwise as pairwise_torch
from . import build as _build

METRIC_IDS = {"l2": 0, "l2sq": 1, "cosine": 2, "l1": 3}

launches = 0
lane_launches = 0

__all__ = ["METRIC_IDS", "host_ints", "lane_rows", "launch", "launch_lanes",
           "launches", "lane_launches", "pairwise_lanes_plain",
           "pairwise_plain", "pairwise_torch"]


def host_ints(t: torch.Tensor):
    """A lane tensor's entries as host ints, in one read: the plain lane
    versions' deliberate read of the counts, column offsets and flags
    that the lane kernels read on the card, so it runs inside
    ``engine.syncs_allowed``."""
    from ..core.engine import syncs_allowed
    with syncs_allowed(t.device):
        return [int(v) for v in t.tolist()]


def lane_rows(rows, lanes: int, n_pad: int):
    """Each lane's row count as host ints (``rows`` a CPU tensor or None)."""
    return [n_pad] * lanes if rows is None else host_ints(rows)


def pairwise_plain(x, y, metric: str, out=None, run=None):
    """Plain version with the kernel's contract: the block is copied into
    ``out`` where one is given, which keeps its values where the run flag
    reads 0; without ``out`` a masked block is the caller's to
    discard."""
    dxy = pairwise_torch(x, y, metric=metric)
    if out is None:
        return dxy
    if run is not None:
        dxy = torch.where(run.bool(), dxy, out)
    return out.copy_(dxy)


def launch(x: torch.Tensor, y: torch.Tensor, metric: str, out=None,
           run=None, *, shape: int) -> torch.Tensor:
    """Run the CUDA kernel on validated CUDA tensors (see ``ops``): into
    ``out`` (unit column stride, any row stride) or a new ``[m, r]``
    tensor; a run flag ``run`` ([1] int32) that reads 0 leaves the output
    unwritten (counted as a launch all the same)."""
    global launches
    m, d = x.shape
    r = y.shape[0]
    if out is None:
        out = torch.empty((m, r), dtype=torch.float32, device=x.device)
    ldo = out.stride(0) if m > 1 else r
    code = _build.lib().rt_pairwise_tiled(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), m, r, ldo, d,
        METRIC_IDS[metric], None if run is None else run.data_ptr(),
        shape, torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    _build.check(code, "pairwise kernel")
    return out


def pairwise_lanes_plain(x, y, metric: str, out=None, col=None, xrows=None,
                         yrows=None, run=None):
    """Plain version of the lane kernel: :func:`pairwise_plain` on each
    lane's ``[xrows[l], d] x [yrows[l], d]`` slices, into
    ``out[l, :m_l, col[l]:col[l] + r_l]`` (a lane at flag 0 keeps it), or
    into a new ``[L, m, r]`` zeros tensor.  A lane whose flag reads 0 on
    the CPU is skipped, as the kernel skips it."""
    lanes, m, r = x.shape[0], x.shape[1], y.shape[1]
    if out is None:
        out = torch.zeros((lanes, m, r), dtype=torch.float32,
                          device=x.device)
    cols = [0] * lanes if col is None else host_ints(col)
    flags = (host_ints(run) if run is not None and run.device.type == "cpu"
             else None)
    # tracecheck: ignore[TRC002] -- the plain lane version (CPU tensors only):
    # the single form once a lane
    for i, (mi, ri) in enumerate(zip(lane_rows(xrows, lanes, m),
                                     lane_rows(yrows, lanes, r))):
        flag = None if run is None else run[i:i + 1]
        if flags is not None and not flags[i]:
            continue
        pairwise_plain(x[i, :mi], y[i, :ri], metric,
                       out[i, :mi, cols[i]:cols[i] + ri], flag)
    return out


def launch_lanes(x: torch.Tensor, y: torch.Tensor, metric: str, out=None,
                 col=None, xrows=None, yrows=None, run=None, *,
                 shape: int) -> torch.Tensor:
    """Run the lane kernel on validated CUDA tensors (see ``ops``): into
    ``out`` ``[L, m, C]`` at each lane's column offset ``col[l]`` (unit
    column stride, any row and lane stride), or a new ``[L, m, r]``
    tensor; past a lane's rows and in a lane whose flag reads 0 the output
    is left as it was."""
    global lane_launches
    lanes, m, d = x.shape
    r = y.shape[1]
    if out is None:
        out = torch.empty((lanes, m, r), dtype=torch.float32,
                          device=x.device)
    ldo = out.stride(1) if m > 1 else out.shape[2]
    lane_out = out.stride(0) if lanes > 1 else 0
    code = _build.lib().rt_pairwise_lanes_tiled(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), lanes, m, r, lane_out,
        ldo, d, METRIC_IDS[metric],
        None if xrows is None else xrows.data_ptr(),
        None if yrows is None else yrows.data_ptr(),
        None if col is None else col.data_ptr(),
        None if run is None else run.data_ptr(),
        shape, torch.cuda.current_stream(x.device).cuda_stream)
    lane_launches += 1
    _build.check(code, "pairwise lane kernel")
    return out
