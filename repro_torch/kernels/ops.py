"""Public wrappers around the port's CUDA kernels.

Counterpart of ``repro.kernels.ops``.  Each wrapper checks device, dtype,
shape and contiguity and raises on what its kernel does not take; the GPU
needs none of the TPU wrappers' 128-padding.  Dispatch is by the device
of the tensors alone:

* CUDA tensors go to the kernel (or the wrapper raises — there is no
  fallback);
* CPU tensors take the kernel's plain PyTorch version, which is how the
  CPU tests reach this module.

``launch_counts()`` / ``reset_launch_counts()`` read and clear the
per-kernel launch counters, which show that a run went through the
kernels; ``add_launches`` counts a CUDA graph's replay as a launch of
each kernel the graph holds.

Tile knobs, as the JAX wrappers': ``tm`` (the row tile) on the
statistics wrappers and ``pairwise_distance``, ``tr`` (the column tile)
on ``pairwise_distance`` and ``stream_top2``, and their lane forms.  A
knob left at None resolves through ``repro_torch.core.tuning`` for the
call's (n, d, k) on the card, as the JAX package's ``_stream_tiles``
does; a fit resolves once and passes every knob (the ``"cuda"`` stats
backend bound to the fit's ``TileConfig``).  Every launch goes to its
kernel's ``_tiled`` C entry with the shape index the knobs name; a shape
the library was not built with raises, on the CPU too.  The plain
versions take no tile.

The lane entry points (``build_g_lanes_stats``, ``swap_g_lanes_stats``,
``stream_top2_lanes``) carry ``fit_batch``: L independent fits padded to
``[L, n_pad, d]`` in one launch, each lane with its own inputs, its row
count ``rows[l]`` and, for the round kernels, its run flag; lane l gives
the bits of the single entry point on its ``[rows[l], d]`` slice.  Their
plain versions loop over the lanes with the single plain versions.  The
PIC batch adds two (``pairwise_lanes``, ``swap_g_from_cache_lanes_stats``)
that write or read each lane's block of a lane ring ``[L, n_pad, C]`` at
the lane's own column offset.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import tuning
from . import build_g as _build_g
from . import pairwise as _pairwise
from . import stream_g as _stream_g
from . import swap_g as _swap_g

# Metrics implemented by the kernels (the registry-facing names).
KERNEL_METRICS = ("l2", "l2sq", "l1", "cosine")

# Kernel name -> (module, its launch counter).
_KERNELS = {"pairwise": (_pairwise, "launches"),
            "build_g": (_build_g, "launches"),
            "swap_g": (_swap_g, "launches"),
            "swap_g_from_cache": (_swap_g, "cached_launches"),
            "top2": (_stream_g, "top2_launches"),
            "stream_build_g": (_stream_g, "stream_build_launches"),
            "stream_swap_g": (_stream_g, "stream_swap_launches"),
            "build_g_lanes": (_build_g, "lane_launches"),
            "swap_g_lanes": (_swap_g, "lane_launches"),
            "top2_lanes": (_stream_g, "top2_lane_launches"),
            "pairwise_lanes": (_pairwise, "lane_launches"),
            "swap_g_from_cache_lanes": (_swap_g, "cached_lane_launches")}

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters: a CUDA
    graph's replay launches its kernels without passing their wrappers
    (``repro_torch.api.predict``)."""
    for name, n in counts.items():
        mod, attr = _KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + int(n))


def _on_cuda(what: str, metric: Optional[str],
             *tensors: torch.Tensor) -> bool:
    """Validate a call; True for the kernel, False for the plain version.
    ``metric=None``: a kernel that computes no distance."""
    if metric is not None and metric not in KERNEL_METRICS:
        raise ValueError(f"{what}: metric {metric!r} has no kernel "
                         f"(kernel metrics: {list(KERNEL_METRICS)})")
    dev = tensors[0].device
    # tracecheck: ignore[TRC002] -- validates the call's argument tensors on
    # the host; no launch
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expects contiguous tensors")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {dev}")


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _run_flag(what: str, run: Optional[torch.Tensor], like: torch.Tensor
              ) -> None:
    """A run flag is a one-element int32 tensor on the data's device."""
    if run is not None:
        _check(run.dtype == torch.int32 and run.numel() == 1
               and run.device == like.device, what,
               f"run must be a one-element int32 tensor on {like.device}")


def _lane_vec(what: str, v: Optional[torch.Tensor], lanes: int,
              like: torch.Tensor, name: str) -> None:
    """A per-lane run flag or row count: ``[lanes]`` int32 on the data's
    device."""
    if v is not None:
        _check(v.dtype == torch.int32 and v.shape == (lanes,)
               and v.device == like.device and v.is_contiguous(), what,
               f"{name} must be a contiguous [{lanes}] int32 tensor on "
               f"{like.device}")


def _lanes_in(what: str, x: torch.Tensor, y: torch.Tensor,
              rows: Optional[torch.Tensor], run: Optional[torch.Tensor],
              vectors) -> None:
    """Shapes of a lane round kernel's inputs: x [L, n_pad, d], y
    [L, B, d], the per-lane batch vectors [L, B], rows and run [L]."""
    _check(x.ndim == 3 and y.ndim == 3 and x.shape[0] == y.shape[0]
           and x.shape[2] == y.shape[2], what,
           f"shapes {tuple(x.shape)} x {tuple(y.shape)}")
    lanes, b = y.shape[0], y.shape[1]
    _check(all(t.shape == (lanes, b) for t in vectors), what,
           "the batch vectors must be [L, B]")
    _lane_vec(what, rows, lanes, x, "rows")
    _lane_vec(what, run, lanes, x, "run")


def _lane_cols(what: str, col: Optional[torch.Tensor], lanes: int,
               like: torch.Tensor) -> None:
    """Per-lane column offsets: ``[lanes]`` int64 on the data's device."""
    if col is not None:
        _check(col.dtype == torch.int64 and col.shape == (lanes,)
               and col.device == like.device and col.is_contiguous(), what,
               f"col must be a contiguous [{lanes}] int64 tensor on "
               f"{like.device}")


def _resolved(x: torch.Tensor, n: int, d: int, k: int
              ) -> tuning.TileConfig:
    """The tuner's config for a launch on ``x``'s card whose knob was
    left unset."""
    return tuning.resolve_tile_config(n, d, k,
                                      tuning.current_device_kind(x.device),
                                      "cuda")


def _row_shape(cuda: bool, x: torch.Tensor, n: int, d: int, k: int,
               tm: Optional[int]) -> Optional[int]:
    """The statistics kernels' shape index (None: a CPU call with no
    knob, which takes no tile)."""
    if tm is None:
        if not cuda:
            return None
        tm = _resolved(x, n, d, k).tm
    return tuning.row_index(tm)


def _pairwise_shape(cuda: bool, x: torch.Tensor, m: int, r: int, d: int,
                    tm: Optional[int], tr: Optional[int]) -> Optional[int]:
    """``pairwise``'s shape index for an [m x r] block."""
    if tm is None or tr is None:
        if not cuda and tm is None and tr is None:
            return None
        cfg = (_resolved(x, m, d, 1) if cuda
               else tuning.TileConfig(tm=tuning.ROW_TILES[0]))
        tm = cfg.tm if tm is None else tm
        tr = cfg.tr if tr is None else tr
    return tuning.pairwise_index(tm, tr, m, r)


def _top2_shape(cuda: bool, x: torch.Tensor, n: int, d: int, k: int,
                tr: Optional[int]) -> Optional[int]:
    """``top2``'s shape index: its column tile ``tr`` (the config's
    ``tk``)."""
    if tr is None:
        if not cuda:
            return None
        tr = _resolved(x, n, d, k).tk
    return tuning.top2_index(tr)


def _cached_shape(what: str, tm: Optional[int]) -> int:
    """``swap_g_from_cache`` has one shape, 32 rows a block."""
    _check(tm is None or int(tm) == tuning.CACHED_SHAPES[0][0], what,
           f"tm={tm}: the kernel has one row tile, "
           f"{tuning.CACHED_SHAPES[0][0]}")
    return 0


def _f32(what: str, *tensors: torch.Tensor) -> None:
    # tracecheck: ignore[TRC002] -- checks the call's argument dtypes on the
    # host; no launch
    for t in tensors:
        _check(t.dtype == torch.float32, what, f"expects float32, got {t.dtype}")


def pairwise_distance(x: torch.Tensor, y: torch.Tensor,
                      metric: str = "l2", *,
                      out: Optional[torch.Tensor] = None,
                      run: Optional[torch.Tensor] = None,
                      tm: Optional[int] = None,
                      tr: Optional[int] = None) -> torch.Tensor:
    """``[m, d] x [r, d] -> [m, r]`` dissimilarities, into ``out`` where
    given (``[m, r]`` float32, adjacent columns, any row stride: a slot of
    the PIC column ring).  ``run`` ([1] int32, optional): where it reads 0
    the kernel returns at once and the output is left as it was.  ``tm``
    / ``tr``: the row tile and the widest column tile
    (``tuning.pairwise_index``)."""
    what = "pairwise_distance"
    cuda = _on_cuda(what, metric, x, y)
    _f32(what, x, y)
    _check(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], what,
           f"shapes {tuple(x.shape)} x {tuple(y.shape)}")
    if out is not None:
        _check(out.shape == (x.shape[0], y.shape[0])
               and out.dtype == torch.float32 and out.device == x.device
               and (out.stride(1) == 1 or out.shape[1] == 1)
               and out.stride(0) >= out.shape[1], what,
               f"out must be a [{x.shape[0]}, {y.shape[0]}] float32 tensor "
               f"on {x.device} with adjacent columns")
    _run_flag(what, run, x)
    shape = _pairwise_shape(cuda, x, x.shape[0], y.shape[0], x.shape[1], tm,
                            tr)
    if cuda:
        return _pairwise.launch(x, y, metric, out, run, shape=shape)
    return _pairwise.pairwise_plain(x, y, metric, out, run)


def build_g_stats(x: torch.Tensor, y: torch.Tensor, dnear_b: torch.Tensor,
                  w: torch.Tensor, lead_g: Optional[torch.Tensor] = None,
                  *, metric: str = "l2",
                  run: Optional[torch.Tensor] = None,
                  tm: Optional[int] = None) -> Stats:
    """Fused BUILD statistics: (Σg, Σg², Σg·g_lead) per arm, [m] each.
    ``run`` ([1] int32, optional): where it reads 0 the kernel returns at
    once and the outputs are unwritten, for the caller to discard.
    ``tm``: the row tile."""
    what = "build_g_stats"
    if lead_g is None:
        lead_g = torch.zeros_like(dnear_b)
    cuda = _on_cuda(what, metric, x, y, dnear_b, w, lead_g)
    _f32(what, x, y, dnear_b, w, lead_g)
    b = y.shape[0]
    _check(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], what,
           f"shapes {tuple(x.shape)} x {tuple(y.shape)}")
    _check(dnear_b.shape == (b,) and w.shape == (b,) and lead_g.shape == (b,),
           what, "dnear_b, w and lead_g must be [B]")
    _run_flag(what, run, x)
    shape = _row_shape(cuda, x, x.shape[0], x.shape[1], 1, tm)
    if cuda:
        return _build_g.launch(x, y, dnear_b, w, lead_g, metric, run,
                               shape=shape)
    return _build_g.build_g_torch(x, y, dnear_b, w, lead_g, metric, run)


def swap_g_stats(x: torch.Tensor, y: torch.Tensor, d1_b: torch.Tensor,
                 d2_b: torch.Tensor, assign_b: torch.Tensor, w: torch.Tensor,
                 k: int, lead_g: Optional[torch.Tensor] = None,
                 *, metric: str = "l2",
                 run: Optional[torch.Tensor] = None,
                 tm: Optional[int] = None) -> Stats:
    """Fused SWAP (FastPAM1) statistics (Σg, Σg², Σg·g_lead), each
    ``[k, m]``: arm (medoid c, candidate x) lives at ``[c, x]``.  ``run``
    and ``tm`` as in :func:`build_g_stats`."""
    what = "swap_g_stats"
    if lead_g is None:
        lead_g = torch.zeros_like(d1_b)
    cuda = _on_cuda(what, metric, x, y, d1_b, d2_b, assign_b, w, lead_g)
    _f32(what, x, y, d1_b, d2_b, w, lead_g)
    _check(assign_b.dtype == torch.int32, what,
           f"assign_b must be int32, got {assign_b.dtype}")
    b = y.shape[0]
    _check(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], what,
           f"shapes {tuple(x.shape)} x {tuple(y.shape)}")
    _check(all(t.shape == (b,) for t in (d1_b, d2_b, assign_b, w, lead_g)),
           what, "d1_b, d2_b, assign_b, w and lead_g must be [B]")
    _check(int(k) >= 1, what, f"k must be >= 1, got {k}")
    _run_flag(what, run, x)
    shape = _row_shape(cuda, x, x.shape[0], x.shape[1], int(k), tm)
    if cuda:
        return _swap_g.launch(x, y, d1_b, d2_b, assign_b, w, int(k), lead_g,
                              metric, run, shape=shape)
    return _swap_g.swap_g_torch(x, y, d1_b, d2_b, assign_b, w, int(k),
                                lead_g, metric, run)


def swap_g_stats_cached(dxy: torch.Tensor, d1_b: torch.Tensor,
                        d2_b: torch.Tensor, assign_b: torch.Tensor,
                        w: torch.Tensor, k: int,
                        lead_g: Optional[torch.Tensor] = None, *,
                        run: Optional[torch.Tensor] = None,
                        tm: Optional[int] = None) -> Stats:
    """``swap_g_stats`` served from a resident distance block: ``dxy``
    [m, B] is a slice of the PIC column ring (one round, or the whole
    ring in the carried-moment repair), read in place: its columns must
    be adjacent (``stride(1) == 1``), its row stride is free.  Returns
    (Σg, Σg², Σg·g_lead), each ``[k, m]``; no distance work.  ``run`` as
    in :func:`build_g_stats`; ``tm`` None or the kernel's one row tile,
    32."""
    what = "swap_g_stats_cached"
    if lead_g is None:
        lead_g = torch.zeros_like(d1_b)
    _check(dxy.ndim == 2, what, f"dxy must be [m, B], got {tuple(dxy.shape)}")
    _check(dxy.stride(1) == 1 or dxy.shape[1] == 1, what,
           "dxy's columns must be adjacent (stride(1) == 1)")
    cuda = _on_cuda(what, None, d1_b, d2_b, assign_b, w, lead_g)
    _check(dxy.device == d1_b.device, what,
           f"tensors on {dxy.device} and {d1_b.device}")
    _f32(what, dxy, d1_b, d2_b, w, lead_g)
    _check(assign_b.dtype == torch.int32, what,
           f"assign_b must be int32, got {assign_b.dtype}")
    b = dxy.shape[1]
    _check(b >= 1, what, "the block has no columns")
    _check(all(t.shape == (b,) for t in (d1_b, d2_b, assign_b, w, lead_g)),
           what, "d1_b, d2_b, assign_b, w and lead_g must be [B]")
    _check(int(k) >= 1, what, f"k must be >= 1, got {k}")
    _run_flag(what, run, dxy)
    shape = _cached_shape(what, tm)
    if cuda:
        return _swap_g.launch_cached(dxy, d1_b, d2_b, assign_b, w, int(k),
                                     lead_g, run, shape=shape)
    return _swap_g.swap_g_from_cache_torch(dxy, d1_b, d2_b, assign_b, w,
                                           int(k), lead_g, run)


def stream_top2(x: torch.Tensor, med_pts: torch.Tensor, *,
                metric: str = "l2", tr: Optional[int] = None) -> Stats:
    """Nearest / second-nearest medoid: ``[n, d]`` × ``[k, d]`` →
    (d1 [n], d2 [n], assign [n] int32); ties go to the lowest index.
    ``tr``: the column tile over the medoids (16, 40, 72 or 104; the
    config's ``tk``)."""
    what = "stream_top2"
    cuda = _on_cuda(what, metric, x, med_pts)
    _f32(what, x, med_pts)
    _check(x.ndim == 2 and med_pts.ndim == 2
           and x.shape[1] == med_pts.shape[1] and med_pts.shape[0] >= 1,
           what, f"shapes {tuple(x.shape)} x {tuple(med_pts.shape)}")
    shape = _top2_shape(cuda, x, x.shape[0], x.shape[1], med_pts.shape[0],
                        tr)
    if cuda:
        return _stream_g.launch_top2(x, med_pts, metric, shape=shape)
    return _stream_g.top2_torch(x, med_pts, metric)


def stream_build_g_stats(x: torch.Tensor, yref: torch.Tensor,
                         dnear: torch.Tensor, w: Optional[torch.Tensor] = None,
                         lead_g: Optional[torch.Tensor] = None,
                         *, metric: str = "l2",
                         run: Optional[torch.Tensor] = None,
                         tm: Optional[int] = None) -> Stats:
    """Streaming BUILD statistics (Σg, Σg², Σg·g_lead) per arm, [m] each,
    over the WHOLE reference set ``yref`` [r, d] (r unbounded): one
    launch walks it in 512-column tiles.  ``w`` defaults to ones and
    ``lead_g`` to zeros; ``run`` as in :func:`build_g_stats` (the exact
    fallback's flag); ``tm`` the row tile."""
    what = "stream_build_g_stats"
    if w is None:
        w = torch.ones_like(dnear)
    if lead_g is None:
        lead_g = torch.zeros_like(dnear)
    cuda = _on_cuda(what, metric, x, yref, dnear, w, lead_g)
    _f32(what, x, yref, dnear, w, lead_g)
    r = yref.shape[0]
    _check(x.ndim == 2 and yref.ndim == 2 and x.shape[1] == yref.shape[1],
           what, f"shapes {tuple(x.shape)} x {tuple(yref.shape)}")
    _check(dnear.shape == (r,) and w.shape == (r,) and lead_g.shape == (r,),
           what, "dnear, w and lead_g must be [r]")
    _check(r >= 1, what, "the reference set is empty")
    _run_flag(what, run, x)
    shape = _row_shape(cuda, x, x.shape[0], x.shape[1], 1, tm)
    if cuda:
        return _stream_g.launch_stream_build(x, yref, dnear, w, lead_g, metric,
                                             run, shape=shape)
    return _stream_g.stream_build_g_torch(x, yref, dnear, w, lead_g, metric,
                                          run)


def stream_swap_g_stats(x: torch.Tensor, yref: torch.Tensor,
                        d1: torch.Tensor, d2: torch.Tensor,
                        assign: torch.Tensor, w: Optional[torch.Tensor] = None,
                        k: int = 1, lead_g: Optional[torch.Tensor] = None,
                        *, metric: str = "l2",
                        run: Optional[torch.Tensor] = None,
                        tm: Optional[int] = None,
                        moments: bool = True) -> Stats:
    """Streaming SWAP (FastPAM1) statistics (Σg, Σg², Σg·g_lead), each
    ``[k, m]``, over the WHOLE reference set ``yref`` [r, d]: arm
    (medoid c, candidate x) at ``[c, x]``.  ``w`` defaults to ones and
    ``lead_g`` to zeros; ``run`` and ``tm`` as in
    :func:`stream_build_g_stats`.  ``moments=False`` gives Σg alone (the
    exact pass's means), None in place of the other two: the kernel then
    writes no ``[k, m]`` table it would discard."""
    what = "stream_swap_g_stats"
    if w is None:
        w = torch.ones_like(d1)
    if lead_g is None:
        lead_g = torch.zeros_like(d1)
    cuda = _on_cuda(what, metric, x, yref, d1, d2, assign, w, lead_g)
    _f32(what, x, yref, d1, d2, w, lead_g)
    _check(assign.dtype == torch.int32, what,
           f"assign must be int32, got {assign.dtype}")
    r = yref.shape[0]
    _check(x.ndim == 2 and yref.ndim == 2 and x.shape[1] == yref.shape[1],
           what, f"shapes {tuple(x.shape)} x {tuple(yref.shape)}")
    _check(all(t.shape == (r,) for t in (d1, d2, assign, w, lead_g)),
           what, "d1, d2, assign, w and lead_g must be [r]")
    _check(r >= 1, what, "the reference set is empty")
    _check(int(k) >= 1, what, f"k must be >= 1, got {k}")
    _run_flag(what, run, x)
    shape = _row_shape(cuda, x, x.shape[0], x.shape[1], int(k), tm)
    if cuda:
        return _stream_g.launch_stream_swap(x, yref, d1, d2, assign, w,
                                            int(k), lead_g, metric, run,
                                            shape=shape, moments=moments)
    out = _stream_g.stream_swap_g_torch(x, yref, d1, d2, assign, w, int(k),
                                        lead_g, metric, run)
    return out if moments else (out[0], None, None)


def build_g_lanes_stats(x: torch.Tensor, y: torch.Tensor,
                        dnear_b: torch.Tensor, w: torch.Tensor,
                        lead_g: Optional[torch.Tensor] = None, *,
                        rows: Optional[torch.Tensor] = None,
                        metric: str = "l2",
                        run: Optional[torch.Tensor] = None,
                        tm: Optional[int] = None) -> Stats:
    """``build_g_stats`` over L lanes in one launch: x ``[L, n_pad, d]``,
    y ``[L, B, d]``, dnear_b / w / lead_g ``[L, B]``, rows and run ``[L]``
    int32 (None: n_pad rows, every lane runs).  Returns (Σg, Σg², Σg·g_lead),
    ``[L, n_pad]`` each; past a lane's rows and in a lane whose flag reads
    0 the kernel leaves them unwritten, for the caller to discard."""
    what = "build_g_lanes_stats"
    if lead_g is None:
        lead_g = torch.zeros_like(dnear_b)
    cuda = _on_cuda(what, metric, x, y, dnear_b, w, lead_g)
    _f32(what, x, y, dnear_b, w, lead_g)
    _lanes_in(what, x, y, rows, run, (dnear_b, w, lead_g))
    shape = _row_shape(cuda, x, x.shape[0] * x.shape[1], x.shape[2], 1, tm)
    if cuda:
        return _build_g.launch_lanes(x, y, dnear_b, w, lead_g, rows, metric,
                                     run, shape=shape)
    return _build_g.build_g_lanes_torch(x, y, dnear_b, w, lead_g, rows,
                                        metric, run)


def swap_g_lanes_stats(x: torch.Tensor, y: torch.Tensor,
                       d1_b: torch.Tensor, d2_b: torch.Tensor,
                       assign_b: torch.Tensor, w: torch.Tensor, k: int,
                       lead_g: Optional[torch.Tensor] = None, *,
                       rows: Optional[torch.Tensor] = None,
                       metric: str = "l2",
                       run: Optional[torch.Tensor] = None,
                       tm: Optional[int] = None) -> Stats:
    """``swap_g_stats`` over L lanes in one launch: x ``[L, n_pad, d]``,
    y ``[L, B, d]``, the batch vectors ``[L, B]``, rows and run as in
    :func:`build_g_lanes_stats`.  Returns (Σg, Σg², Σg·g_lead), each
    ``[L, k, n_pad]``: lane l's arm (c, x) at ``[l, c, x]``."""
    what = "swap_g_lanes_stats"
    if lead_g is None:
        lead_g = torch.zeros_like(d1_b)
    cuda = _on_cuda(what, metric, x, y, d1_b, d2_b, assign_b, w, lead_g)
    _f32(what, x, y, d1_b, d2_b, w, lead_g)
    _check(assign_b.dtype == torch.int32, what,
           f"assign_b must be int32, got {assign_b.dtype}")
    _lanes_in(what, x, y, rows, run, (d1_b, d2_b, assign_b, w, lead_g))
    _check(int(k) >= 1, what, f"k must be >= 1, got {k}")
    shape = _row_shape(cuda, x, x.shape[0] * x.shape[1], x.shape[2], int(k),
                       tm)
    if cuda:
        return _swap_g.launch_lanes(x, y, d1_b, d2_b, assign_b, w, int(k),
                                    lead_g, rows, metric, run, shape=shape)
    return _swap_g.swap_g_lanes_torch(x, y, d1_b, d2_b, assign_b, w, int(k),
                                      lead_g, rows, metric, run)


def stream_top2_lanes(x: torch.Tensor, med_pts: torch.Tensor, *,
                      rows: Optional[torch.Tensor] = None,
                      metric: str = "l2", tr: Optional[int] = None) -> Stats:
    """``stream_top2`` over L lanes in one launch: x ``[L, n_pad, d]``
    against each lane's medoids ``[L, k, d]``, rows ``[L]`` int32 (None:
    n_pad).  Returns (d1, d2, assign int32), ``[L, n_pad]`` each,
    unwritten past a lane's rows."""
    what = "stream_top2_lanes"
    cuda = _on_cuda(what, metric, x, med_pts)
    _f32(what, x, med_pts)
    _check(x.ndim == 3 and med_pts.ndim == 3
           and x.shape[0] == med_pts.shape[0]
           and x.shape[2] == med_pts.shape[2] and med_pts.shape[1] >= 1,
           what, f"shapes {tuple(x.shape)} x {tuple(med_pts.shape)}")
    _lane_vec(what, rows, x.shape[0], x, "rows")
    shape = _top2_shape(cuda, x, x.shape[0] * x.shape[1], x.shape[2],
                        med_pts.shape[1], tr)
    if cuda:
        return _stream_g.launch_top2_lanes(x, med_pts, rows, metric,
                                           shape=shape)
    return _stream_g.top2_lanes_torch(x, med_pts, rows, metric)


def pairwise_lanes(x: torch.Tensor, y: torch.Tensor, metric: str = "l2", *,
                   out: Optional[torch.Tensor] = None,
                   col: Optional[torch.Tensor] = None,
                   xrows: Optional[torch.Tensor] = None,
                   yrows: Optional[torch.Tensor] = None,
                   run: Optional[torch.Tensor] = None,
                   tm: Optional[int] = None,
                   tr: Optional[int] = None) -> torch.Tensor:
    """``pairwise_distance`` over L lanes in one launch: x ``[L, m, d]``
    against y ``[L, r, d]``, lane l over its first ``xrows[l]`` and
    ``yrows[l]`` rows (``[L]`` int32; None: m and r).  Into ``out``
    ``[L, m, C]`` (float32, adjacent columns, any row and lane stride: a
    lane ring) at columns ``[col[l], col[l] + r_l)`` of lane l (``col``
    ``[L]`` int64, None: 0; the caller keeps ``col[l] + r_l <= C``), or
    into a new ``[L, m, r]`` tensor.  A lane whose flag ``run[l]`` reads 0
    and the entries past a lane's rows are left as they were (unwritten
    in a new tensor)."""
    what = "pairwise_lanes"
    cuda = _on_cuda(what, metric, x, y)
    _f32(what, x, y)
    _check(x.ndim == 3 and y.ndim == 3 and x.shape[0] == y.shape[0]
           and x.shape[2] == y.shape[2], what,
           f"shapes {tuple(x.shape)} x {tuple(y.shape)}")
    lanes, m, r = x.shape[0], x.shape[1], y.shape[1]
    if out is not None:
        _check(out.ndim == 3 and out.shape[:2] == (lanes, m)
               and out.shape[2] >= r and out.dtype == torch.float32
               and out.device == x.device
               and (out.stride(2) == 1 or out.shape[2] == 1)
               and out.stride(1) >= out.shape[2], what,
               f"out must be an [{lanes}, {m}, >= {r}] float32 tensor on "
               f"{x.device} with adjacent columns")
    _check(out is not None or col is None, what, "col needs out")
    _lane_cols(what, col, lanes, x)
    _lane_vec(what, xrows, lanes, x, "xrows")
    _lane_vec(what, yrows, lanes, x, "yrows")
    _lane_vec(what, run, lanes, x, "run")
    shape = _pairwise_shape(cuda, x, m, r, x.shape[2], tm, tr)
    if cuda:
        return _pairwise.launch_lanes(x, y, metric, out, col, xrows, yrows,
                                      run, shape=shape)
    return _pairwise.pairwise_lanes_plain(x, y, metric, out, col, xrows,
                                          yrows, run)


def swap_g_from_cache_lanes_stats(dxy: torch.Tensor, d1_b: torch.Tensor,
                                  d2_b: torch.Tensor, assign_b: torch.Tensor,
                                  w: torch.Tensor, k: int,
                                  lead_g: Optional[torch.Tensor] = None, *,
                                  col: Optional[torch.Tensor] = None,
                                  rows: Optional[torch.Tensor] = None,
                                  run: Optional[torch.Tensor] = None,
                                  tm: Optional[int] = None) -> Stats:
    """``swap_g_stats_cached`` over L lanes in one launch: lane l's block
    is ``dxy[l, :rows[l], col[l]:col[l] + B]`` of a lane ring ``dxy``
    ``[L, n_pad, C]`` (adjacent columns, any row and lane stride; ``col``
    ``[L]`` int64, None: 0; the caller keeps ``col[l] + B <= C``), the
    batch vectors ``[L, B]``, rows and run ``[L]`` int32 as in
    :func:`build_g_lanes_stats`.  Returns (Σg, Σg², Σg·g_lead), each
    ``[L, k, n_pad]``: lane l's arm (c, x) at ``[l, c, x]``, unwritten past
    a lane's rows and in a lane whose flag reads 0."""
    what = "swap_g_from_cache_lanes_stats"
    if lead_g is None:
        lead_g = torch.zeros_like(d1_b)
    _check(dxy.ndim == 3, what,
           f"dxy must be [L, n_pad, C], got {tuple(dxy.shape)}")
    _check(dxy.stride(2) == 1 or dxy.shape[2] == 1, what,
           "dxy's columns must be adjacent (stride(2) == 1)")
    cuda = _on_cuda(what, None, d1_b, d2_b, assign_b, w, lead_g)
    _check(dxy.device == d1_b.device, what,
           f"tensors on {dxy.device} and {d1_b.device}")
    _f32(what, dxy, d1_b, d2_b, w, lead_g)
    _check(assign_b.dtype == torch.int32, what,
           f"assign_b must be int32, got {assign_b.dtype}")
    lanes, b = dxy.shape[0], d1_b.shape[-1]
    _check(b >= 1 and b <= dxy.shape[2], what,
           f"a block of {b} columns in a ring of {dxy.shape[2]}")
    _check(all(t.shape == (lanes, b)
               for t in (d1_b, d2_b, assign_b, w, lead_g)), what,
           "the batch vectors must be [L, B]")
    _check(int(k) >= 1, what, f"k must be >= 1, got {k}")
    _lane_cols(what, col, lanes, dxy)
    _lane_vec(what, rows, lanes, dxy, "rows")
    _lane_vec(what, run, lanes, dxy, "run")
    shape = _cached_shape(what, tm)
    if cuda:
        return _swap_g.launch_cached_lanes(dxy, d1_b, d2_b, assign_b, w,
                                           int(k), lead_g, col, rows, run,
                                           shape=shape)
    return _swap_g.swap_g_from_cache_lanes_torch(dxy, d1_b, d2_b, assign_b, w,
                                                 int(k), lead_g, col, rows,
                                                 run)
