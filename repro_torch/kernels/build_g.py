"""Fused BUILD arm statistics: ``(Σg, Σg², Σg·g_lead)`` per candidate.

Replaces the TPU kernel ``src/repro/kernels/build_g.py:42``
(``build_g_kernel``) with the CUDA kernel ``csrc/build_g.cu``.  On the
H100 a round at n=60000, B=100, d=784 is 9.4 GFLOP of float32 distance
work against 188 MB of reads, so it is compute-bound (about 140 us at
67 TFLOP/s).  The design runs the pipelined mainloop of
``csrc/dist_mainloop.cuh`` over a tile of 128 rows (or 64 or 32, the row
tile ``repro_torch.core.tuning`` resolved) by 104 columns (a whole
B = 100 batch), puts the distance tile in shared memory and folds it into four residue
partials per row added in a fixed order: no atomics, the same bits on
every run, and at B <= 512 the bits of ``stream_build_g``.

``build_g_torch`` is the plain version (the engine's Eq. 6 math over a
materialised ``[m, B]`` block).  ``launches`` counts kernel launches.

The lane axis (``fit_batch``): ``launch_lanes`` runs the same kernel over
L padded fits ``[L, n_pad, d]`` in one launch (``rt_build_g_lanes``),
each lane with its own batch, run flag and row count, and gives lane l
the bits of a single launch on its own slice.  ``build_g_lanes_torch``,
its plain version, loops over the lanes with ``build_g_torch``;
``lane_launches`` counts the lane kernel's launches.
"""

from __future__ import annotations

import torch

from ..core.distances import pairwise
from ..core.engine import _build_g
from . import build as _build
from .pairwise import METRIC_IDS, lane_rows

launches = 0
lane_launches = 0


def build_g_torch(x, y, dnear_b, w, lead_g, metric: str, run=None):
    """Plain version: ``g = (d − dnear) ∧ 0`` (``d`` where dnear = inf),
    times ``w``; returns the three ``[m]`` sums.  It computes them
    whatever the run flag says; the caller discards a masked round's."""
    g = _build_g(pairwise(x, y, metric=metric), dnear_b) * w[None, :]
    return torch.sum(g, dim=1), torch.sum(g * g, dim=1), g @ lead_g


def launch(x, y, dnear_b, w, lead_g, metric: str, run=None, *,
           shape: int):
    """Run the CUDA kernel on validated CUDA tensors (see ``ops``).  A
    run flag ``run`` ([1] int32) that reads 0 makes every block return at
    once and leaves the outputs unwritten; the launch counts all the
    same."""
    global launches
    m, d = x.shape
    b = y.shape[0]
    sums, sq, cross = (torch.empty((m,), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
    code = _build.lib().rt_build_g_tiled(
        x.data_ptr(), y.data_ptr(), dnear_b.data_ptr(), w.data_ptr(),
        lead_g.data_ptr(), sums.data_ptr(), sq.data_ptr(), cross.data_ptr(),
        m, b, d, METRIC_IDS[metric], None if run is None else run.data_ptr(),
        shape, torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    _build.check(code, "build_g kernel")
    return sums, sq, cross


def build_g_lanes_torch(x, y, dnear_b, w, lead_g, rows, metric: str,
                        run=None):
    """Plain version of the lane kernel: ``build_g_torch`` on each lane's
    ``[rows[l], d]`` slice, into ``[L, n_pad]`` zeros (the rows past a
    lane's count stay 0); every lane is computed whatever its flag."""
    lanes, n_pad = x.shape[0], x.shape[1]
    outs = [torch.zeros((lanes, n_pad), dtype=torch.float32,
                        device=x.device) for _ in range(3)]
    # tracecheck: ignore[TRC002] -- the plain lane version (CPU tensors only):
    # the single form once a lane
    for i, n in enumerate(lane_rows(rows, lanes, n_pad)):
        part = build_g_torch(x[i, :n], y[i], dnear_b[i], w[i], lead_g[i],
                             metric)
        # tracecheck: ignore[TRC002] -- the three outputs
        for o, v in zip(outs, part):
            o[i, :n] = v
    return tuple(outs)


def launch_lanes(x, y, dnear_b, w, lead_g, rows, metric: str, run=None, *,
                 shape: int):
    """Run the lane kernel on validated CUDA tensors (see ``ops``):
    outputs ``[L, n_pad]``, unwritten past each lane's rows and in every
    lane whose run flag reads 0."""
    global lane_launches
    lanes, n_pad, d = x.shape
    b = y.shape[1]
    sums, sq, cross = (torch.empty((lanes, n_pad), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
    code = _build.lib().rt_build_g_lanes_tiled(
        x.data_ptr(), y.data_ptr(), dnear_b.data_ptr(), w.data_ptr(),
        lead_g.data_ptr(), sums.data_ptr(), sq.data_ptr(), cross.data_ptr(),
        lanes, n_pad, b, d, METRIC_IDS[metric],
        None if rows is None else rows.data_ptr(),
        None if run is None else run.data_ptr(),
        shape, torch.cuda.current_stream(x.device).cuda_stream)
    lane_launches += 1
    _build.check(code, "build_g lane kernel")
    return sums, sq, cross
