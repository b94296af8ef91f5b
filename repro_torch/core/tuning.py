"""Tile tuner for the port's kernels (counterpart of
``repro.core.tuning``): the one point that picks every kernel's tile.

Every distance kernel of the port runs the mainloop of
``kernels/csrc/dist_mainloop.cuh`` in a block shape compiled into the
library, and every ``_tiled`` C entry takes the shape's index; nothing
in C chooses a shape.  Four knobs, one :class:`TileConfig`:

* ``tm`` — the row tile, the mainloop shape's BM (128, 64 or 32) of
  ``build_g``, ``swap_g``, ``stream_build_g``, ``stream_swap_g`` (their
  lane forms too) and of ``pairwise``'s wide shapes.  The statistics
  kernels and their folds vary only the row side (a thread's rows, RM):
  the 104-column tile and its thread columns fix each row's column
  order, so every row tile gives the same bits.
* ``tb`` — the reference-tile width of the streaming walks.  **Pinned to
  ``REF_TILE``** (512, the engine's ``_EXACT_CHUNK`` and the
  ``REF_TILE`` of ``stream_stats.cu`` and ``swap_g.cu``): the per-arm
  sums add one tile's sum at a time in walk order, so another width
  regroups the float32 adds and forfeits the bit contract.
* ``tr`` — the widest column tile ``pairwise`` takes (104 or 128): a
  block of r <= 104 columns takes the 104-column tile (a whole B = 100
  batch, 4 % padding), a wider one the ``tr`` tile (a sharded round's
  [n x 128] block is one 128-column tile, not two of 104).  A block of
  r <= 16 columns, or of m <= 16 rows, takes the narrow tile.
* ``tk`` — ``top2``'s column tile over the k medoids (16, 40, 72 or
  104; its row tile comes with it), the shortest walk of
  ``ceil(k / tk)`` tiles at each tile's measured time.  A second column
  knob, beside ``tr``, because the two kernels see different widths in
  one fit (a k = 10 fit's top2 wants 16 columns, its PIC blocks 104).
  ``pairwise`` and ``top2`` store each pair (or the first index of a
  tie) on their own, so their column tile may vary with the bits kept.
* ``dk`` — ``d`` rounded up to the stage width (16 features).  The card
  has no feature ceiling: features stream through the cp.async stages
  of shared memory a chunk at a time, so the JAX wrappers' ``DK_MAX``
  fallback (a VMEM budget) has no counterpart and ``dk`` only records
  the staged width.

``swap_g_from_cache`` has one shape (32 rows a block, any B): its
entry in ``KERNEL_SHAPES``, the candidates, is that shape alone, and
every launch takes index 0.

:func:`resolve_tile_config` is the single resolution point, keyed on
``(n, d, k, device kind, backend)`` with the JAX package's power-of-two
buckets.  It consults a measured ledger first (:func:`observe` records a
fit's ``wall_by_phase`` against the config that produced it; later
resolves of the bucket return the fastest recorded config) and falls
back to :func:`heuristic`, a wave model of this card: each candidate row
tile's blocks an SM come from the occupancy calculator
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, through the
library's shape queries, once per kernel and shape), the SM count from
``torch.cuda.get_device_properties``, and a tile's time from the table
``TILE_US`` below, measured by ``chip_smoke.py``.  ``BanditPAM.fit``
resolves once a fit and feeds the ledger at its end; ``fit_batch`` and
the sharded fit resolve through the same point and do not observe.  On
the plain backend (``"torch"``) the config is the floor: the plain
versions take no tile.

The ledger is in-process state (a dict), deliberately: tile timing is
specific to the card, and a persisted cache would go stale across
drivers and cards.  A serving process warms it once at start-up (fit
under each of :func:`candidates`, or :func:`observe` measured walls).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Iterable, Optional, Tuple

import torch

# Reference-tile width every bit-checked streaming path is pinned to.
# MUST stay equal to engine._EXACT_CHUNK and to the REF_TILE constants of
# kernels/csrc/stream_stats.cu and swap_g.cu (tests/test_torch_tuning.py).
REF_TILE = 512
STAGE_K = 16        # features a pipeline stage holds (the wide tiles' BK)
NARROW = 16         # the narrow tile's columns: r or m at most this

# The compiled shapes, (rows, columns) in the C entries' index order.
ROW_TILES = (128, 64, 32)                  # BM at 104 columns
ROW_SHAPES = tuple((bm, 104) for bm in ROW_TILES)
PAIRWISE_COLS = (104, 128)                 # pairwise's wide column tiles
# 0: narrow, 1: narrow with the operands swapped (m <= 16), then every
# row tile at each wide column tile.
PAIRWISE_SHAPES = ((64, 16), (64, 16)) + tuple(
    (bm, bn) for bn in PAIRWISE_COLS for bm in ROW_TILES)
TOP2_SHAPES = ((64, 16), (128, 40), (128, 72), (128, 104))
CACHED_SHAPES = ((32, 0),)                 # any B: it walks the columns
KERNEL_SHAPES = {"pairwise": PAIRWISE_SHAPES, "build_g": ROW_SHAPES,
                 "swap_g": ROW_SHAPES, "stream_build_g": ROW_SHAPES,
                 "stream_swap_g": ROW_SHAPES, "top2": TOP2_SHAPES,
                 "swap_g_from_cache": CACHED_SHAPES}
_PAIRWISE_INDEX = {s: i for i, s in enumerate(PAIRWISE_SHAPES) if i >= 2}
_TOP2_INDEX = {bn: i for i, (_, bn) in enumerate(TOP2_SHAPES)}

# Measured tile times, microseconds (chip_smoke.py phase 10 (b), its
# "TILE_US" line; CUDA events; d = 784, l2; NVIDIA H100 80GB HBM3, power
# limit 700.00 W).  "rows": build_g at B = 100 over (one block an SM,
# every SM full at its occupancy) of each row tile; "pairwise": the same
# for each wide shape at r = its columns (the 128 x 128 tile holds one
# block an SM); "top2": one column tile's walk over n = 60,000 rows.
# Another card uses the H100's numbers: the model only compares the
# candidates with one another.
H100 = "NVIDIA H100 80GB HBM3"
TILE_US = {H100: {
    "rows": {128: (123.5, 157.8), 64: (60.3, 94.6), 32: (54.1, 78.3)},
    "pairwise": {(128, 104): (129.3, 164.4), (64, 104): (62.7, 132.9),
                 (32, 104): (51.1, 107.8), (128, 128): (102.5, 102.3),
                 (64, 128): (72.1, 155.4), (32, 128): (53.7, 117.9)},
    "top2": {16: 113.9, 40: 156.9, 72: 234.4, 104: 318.4},
}}


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Resolved tile sizes for one fit's launches."""

    tm: int              # row tile (BM) of the statistics and pairwise
    tb: int = REF_TILE   # reference-tile width (pinned)
    tr: int = 104        # widest column tile of pairwise
    tk: int = 16         # top2's column tile
    dk: int = STAGE_K    # d rounded up to the stage width


# -- shape indices: what a launch passes to its _tiled C entry ----------

def row_index(tm: int) -> int:
    """The statistics kernels' shape index of row tile ``tm``."""
    try:
        return ROW_TILES.index(int(tm))
    except ValueError:
        raise ValueError(f"row tile tm={tm} is not compiled (have "
                         f"{list(ROW_TILES)})") from None


def pairwise_index(tm: int, tr: int, m: int, r: int) -> int:
    """``pairwise``'s shape index for an [m x r] block under (tm, tr)."""
    if int(tr) not in PAIRWISE_COLS:
        raise ValueError(f"pairwise column tile tr={tr} is not compiled "
                         f"(have {list(PAIRWISE_COLS)})")
    row_index(tm)
    if r <= NARROW:
        return 0
    if m <= NARROW:
        return 1
    bn = PAIRWISE_COLS[0] if r <= PAIRWISE_COLS[0] else int(tr)
    try:
        return _PAIRWISE_INDEX[int(tm), bn]
    except KeyError:
        raise ValueError(f"pairwise tile {int(tm)} x {bn} is not compiled "
                         f"(have {PAIRWISE_SHAPES[2:]})") from None


def top2_index(tk: int) -> int:
    """``top2``'s shape index of column tile ``tk``."""
    try:
        return _TOP2_INDEX[int(tk)]
    except KeyError:
        raise ValueError(f"top2 column tile {tk} is not compiled (have "
                         f"{sorted(_TOP2_INDEX)})") from None


# -- the card ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def current_device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``, read once) for a
    CUDA device, else ``"cpu"``; ``None``: the default device of the
    port's entry points, the card where there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return _card_name(dev.index if dev.index is not None
                      else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def sm_count() -> int:
    """The current card's SM count."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


@functools.lru_cache(maxsize=None)
def shape_info(kernel: str, shape: int, k: int = 1) -> Tuple[int, ...]:
    """(rows, columns, threads, blocks an SM) of ``kernel``'s shape
    ``shape`` at k clusters, from the library's occupancy query."""
    from ..kernels import build as _build
    info = (ctypes.c_int * 4)()
    code = getattr(_build.lib(), f"rt_{kernel}_shape")(shape, int(k), info)
    _build.check(code, f"{kernel} shape {shape} query")
    return tuple(info)


def blocks_per_sm(kernel: str, shape: int, k: int = 1) -> int:
    return shape_info(kernel, shape, k)[3]


# -- the model -----------------------------------------------------------

def _bucket(v: int) -> int:
    """Power-of-two shape bucket: tile choice is insensitive to exact n."""
    return 1 << max(int(v) - 1, 0).bit_length()


def shape_key(n: int, d: int, k: int, device_kind: Optional[str] = None,
              backend: str = "torch") -> Tuple:
    if device_kind is None:
        device_kind = current_device_kind()
    return (_bucket(n), _bucket(d), _bucket(k), device_kind, backend)


def _table(device_kind: str) -> dict:
    return TILE_US.get(device_kind, TILE_US[H100])


def wave_us(blocks: int, sms: int, per_sm: int,
            times: Tuple[float, float]) -> float:
    """Time of ``blocks`` blocks spread over ``sms`` SMs that hold
    ``per_sm`` each at once: the busiest SM's full waves at the full
    wave's time, then its last blocks at a time between one block's and
    a full wave's."""
    one, full = times
    per_sm = max(int(per_sm), 1)
    busiest = -(-int(blocks) // max(int(sms), 1))
    waves, rest = divmod(busiest, per_sm)
    t = waves * full
    if rest:
        t += one + (full - one) * (rest - 1) / max(per_sm - 1, 1)
    return t


def top2_tile(k: int, device_kind: str = H100) -> int:
    """top2's column tile whose walk over k medoids, ``ceil(k / tk)``
    tiles at each tile's measured time, is shortest (the narrower on a
    tie)."""
    us = _table(device_kind)["top2"]
    return min(sorted(us), key=lambda bn: -(-max(int(k), 1) // bn) * us[bn])


def _floor(d: int, k: int, device_kind: str) -> TileConfig:
    return TileConfig(tm=ROW_TILES[0], tr=PAIRWISE_COLS[0],
                      tk=top2_tile(k, device_kind),
                      dk=-(-max(int(d), 1) // STAGE_K) * STAGE_K)


@functools.lru_cache(maxsize=1024)
def heuristic(n: int, d: int, k: int, device_kind: Optional[str] = None,
              backend: str = "torch") -> TileConfig:
    """The wave model.  ``tm``: the row tile whose launch over n rows
    (``build_g``'s, the rounds' kernel; its blocks an SM from the
    occupancy calculator) the model times shortest, the larger on a tie
    (fewer blocks stage the batch fewer times).  ``tr``: the column tile
    whose walk over 128 columns (the JAX wrapper's ``tr``) at that row
    tile is shorter.  ``tk``: :func:`top2_tile`.  Under ``"torch"`` the
    floor: the row tile 128, ``tr`` 104 (the shapes of the unchanged
    ``rt_*`` entries) and top2's pick; the plain versions take none."""
    if device_kind is None:
        device_kind = current_device_kind()
    base = _floor(d, k, device_kind)
    if backend != "cuda":
        return base
    table, sms = _table(device_kind), sm_count()
    n = max(int(n), 1)

    def rows_us(tm):
        per = blocks_per_sm("build_g", row_index(tm))
        return wave_us(-(-n // tm), sms, per, table["rows"][tm])

    tm = min(ROW_TILES, key=lambda t: (rows_us(t), -t))

    def cols_us(bn):
        idx = _PAIRWISE_INDEX[tm, bn]
        per = blocks_per_sm("pairwise", idx)
        return -(-128 // bn) * wave_us(-(-n // tm), sms, per,
                                       table["pairwise"][tm, bn])

    tr = min(PAIRWISE_COLS, key=lambda bn: (cols_us(bn), -bn))
    return dataclasses.replace(base, tm=tm, tr=tr)


def candidates(n: int, d: int, k: int, device_kind: Optional[str] = None,
               backend: str = "torch") -> Iterable[TileConfig]:
    """Sweepable configs for :func:`observe` feeders: the heuristic's,
    then each compiled value of one knob at a time (row tiles up to
    twice n, as the JAX package's)."""
    base = heuristic(n, d, k, device_kind, backend)
    seen = [base]
    variants = ([dataclasses.replace(base, tm=tm) for tm in ROW_TILES
                 if tm <= max(int(n), 1) * 2]
                + [dataclasses.replace(base, tr=tr) for tr in PAIRWISE_COLS]
                + [dataclasses.replace(base, tk=bn)
                   for _, bn in TOP2_SHAPES])
    for cfg in variants:
        if cfg not in seen:
            seen.append(cfg)
    return seen


# -- the ledger ----------------------------------------------------------

# measured ledger: shape_key -> {TileConfig: best wall seconds}
_LEDGER: Dict[Tuple, Dict[TileConfig, float]] = {}


def observe(n: int, d: int, k: int, config: TileConfig,
            wall_by_phase: Dict[str, float],
            device_kind: Optional[str] = None,
            backend: str = "torch") -> None:
    """Record a measured wall (sum of the distance-phase walls) for the
    config that produced it.  Best-of is kept per config so noisy reps
    only ever improve the estimate."""
    wall = float(sum(wall_by_phase.get(p, 0.0)
                     for p in ("build", "swap", "loss", "stream")))
    if wall <= 0.0:
        return
    key = shape_key(n, d, k, device_kind, backend)
    best = _LEDGER.setdefault(key, {})
    best[config] = min(best.get(config, float("inf")), wall)


def resolve_tile_config(n: int, d: int, k: int,
                        device_kind: Optional[str] = None,
                        backend: str = "torch") -> TileConfig:
    """Measured-best config for the shape bucket, else the heuristic."""
    key = shape_key(n, d, k, device_kind, backend)
    measured = _LEDGER.get(key)
    if measured:
        return min(measured.items(), key=lambda kv: kv[1])[0]
    return heuristic(n, d, k, key[3], backend)


def ledger_snapshot() -> Dict[Tuple, Dict[TileConfig, float]]:
    """Copy of the measured ledger (benchmark / test introspection)."""
    return {k: dict(v) for k, v in _LEDGER.items()}


def clear_ledger() -> None:
    _LEDGER.clear()
