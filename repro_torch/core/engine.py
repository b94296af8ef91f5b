"""StatsBackend — the seam between the bandit fit loop and the
g-statistics compute paths (counterpart of ``repro.core.engine``).

Two backends, registered by name:

* ``"torch"`` — the plain PyTorch versions (the Eq. 6 / Eq. 12 math
  below over materialised ``[n, B]`` blocks); any kernel metric, any
  device.  On the CPU it is what the tests hold against the JAX
  package's ``"jnp"`` backend.
* ``"cuda"`` — the port's hand-written kernels (``repro_torch.kernels``):
  fused distance + statistics for BUILD and SWAP rounds, the top-2 pass
  behind the medoid cache, the loss and the labels, and the pairwise
  tile for the BUILD ``d_near`` update and predict.  CUDA tensors only.

``resolve_stats_backend`` picks ``"cuda"`` on a CUDA device for the
kernel metrics and ``"torch"`` on the CPU.  The registry stays open
(``register_stats_backend``).

Backend contract (every method takes and returns tensors on the data's
device)::

    pairwise(x, y, *, metric, out=None, run=None)           -> [m, r]
    build_stats(data, ref_idx, dnear_b, w, lead, *, metric, run=None)
                                                            -> 3 × [n]
    build_stats_from_d(dxy, dnear_b, w, lead)               -> 3 × [n]
    swap_stats(data, ref_idx, d1_b, d2_b, assign_b, w, k, lead, *, metric,
               run=None)                                    -> 3 × [k·n]
    swap_stats_from_d(dxy, d1_b, d2_b, assign_b, w, k, lead, run=None)
                                                            -> 3 × [k·n]
    stream_build_sums(data, dnear, *, metric, run=None)     -> [n]
    stream_swap_sums(data, d1, d2, assign, k, *, metric, rows=None,
                     run=None)                              -> [k·m]
    top2(x, med_pts, *, metric)                    -> (d1, d2, assign)

The round statistics are (Σg, Σg², Σg·g_lead) over the batch, where
``lead`` is the leader arm of ``baseline="leader"`` (None: the cross-sum
is zeros and costs nothing) as a 0-d int64 device index, read without
a sync.  ``run`` is the
device-resident search's ``[1]`` int32 flag, 0 for a round enqueued after
the stop (for the streaming sums: for a search that needs no exact
fallback): the kernels return at once, the plain math runs all the same,
and the search discards the result either way.  ``pairwise`` writes into
``out`` where one is given (a slot of the PIC ring, any row stride), and
there a flag of 0 leaves ``out`` as it was on both backends.  Arm
``(medoid c, candidate x)`` of the SWAP statistics sits at flat index
``c·n + x``, the JAX package's order, so a SWAP leader ``lead`` is
medoid ``lead // n`` and candidate ``lead % n``.  The streaming sums are
Σg over the WHOLE dataset, walked in ``_EXACT_CHUNK``-column reference
tiles added in walk order: the exact passes behind replacement
sampling's fallback and behind PAM (:func:`exact_build_means`,
:func:`exact_swap_means`); ``rows`` (an index tensor) restricts the SWAP
sums' candidates to those rows of ``data``, m of them (FasterPAM's
candidate blocks).

The lane forms carry ``fit_batch`` (``core/batch.py``): L independent
fits padded to ``[L, n_pad, d]`` (:class:`LaneData`), each round's
statistics for every lane at once::

    build_stats_lanes(lanes, ref_idx, dnear_b, w, lead, *, metric, run)
                                                            -> 3 × [L, n_pad]
    swap_stats_lanes(lanes, ref_idx, d1_b, d2_b, assign_b, w, k, lead, *,
                     metric, run)                           -> 3 × [L, k·n_pad]
    top2_lanes(lanes, med_idx, *, metric, live=None)        -> 3 × [L, n_pad]

``ref_idx`` ``[L, B]`` indexes each lane's own rows, ``lead`` is ``[L]``
(a SWAP leader ``c·n_pad + x``), ``run`` ``[L]`` int32, and ``live``
(a ``[L]`` bool device tensor) leaves a lane's top-2 unwritten.  Lane
l's values are the single form's on its own ``[n_l, d]`` slice, bit for
bit: ``"cuda"`` launches the lane kernels once a round, and the plain
backend loops over the lanes with its single forms (:class:`_LaneLoop`).
Entries past a lane's ``n_l`` and the entries of a masked lane are for
the caller to discard.  The PIC batch adds the lane forms of the
pairwise path and of the served statistics, over each lane's block of a
lane ring (:class:`LaneBlocks`)::

    pairwise_lanes(x, y, *, metric, out=None, col=None, xrows=None,
                   yrows=None, run=None)                   -> [L, m, ·]
    build_stats_from_d_lanes(lanes, blocks, dnear_b, w, lead)
                                                            -> 3 × [L, n_pad]
    swap_stats_from_d_lanes(lanes, blocks, d1_b, d2_b, assign_b, w, k,
                            lead, run=None)                 -> 3 × [L, k·n_pad]

``pairwise_lanes`` is ``ops.pairwise_lanes``' contract (lane l's
``[xrows[l], d] x [yrows[l], d]`` pairs into ``out[l]`` at column
``col[l]``, a lane at flag 0 left as it was).

The ``*_from_d`` forms take a resident ``[n, B]`` distance block ``dxy``
(a round's slice of the PIC column ring, the warm block, or the whole
ring in the carried-moment repair) in place of the points, so they do no
distance work: on the ``"cuda"`` backend SWAP goes through the
``swap_g_from_cache`` kernel, and BUILD is plain tensor math on both
backends, as in the JAX package.  :func:`stream_columns` produces cache
columns, and :class:`FitContext` holds a fit's cache regime.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels.pairwise import pairwise_lanes_plain, pairwise_plain
from .distances import pairwise
from .pic_cache import PicCache, to_device
from .tuning import REF_TILE, TileConfig

_EXACT_CHUNK = 512  # row tile of the top-2 / loss walks, reference tile
#                    of the exact streaming passes (the JAX REF_TILE)

# The streaming kernels' reference tile must share the exact passes'
# chunk boundaries: that is what makes their walk add each arm's sums in
# the plain walk's order (tuning.REF_TILE, pinned).
assert REF_TILE == _EXACT_CHUNK, (REF_TILE, _EXACT_CHUNK)
# Rows per strip of the plain streaming walks.  It only bounds the live
# [rows, _EXACT_CHUNK] block: each row's sums are independent of it.
_STREAM_ROWS = 16 * _EXACT_CHUNK


# ---------------------------------------------------------------------------
# g-statistics math (the Eq. 6 / Eq. 12 forms shared by every caller)
# ---------------------------------------------------------------------------

def _build_g(dxy: torch.Tensor, dnear_b: torch.Tensor) -> torch.Tensor:
    """Eq. 6 with the Eq. 4 special case for the first assignment."""
    dn = dnear_b[None, :]
    return torch.where(torch.isinf(dn), dxy, torch.clamp_max(dxy - dn, 0.0))


def _swap_terms(dxy: torch.Tensor, d1_b: torch.Tensor, d2_b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    m1 = torch.minimum(dxy, d1_b[None, :])
    base = m1 - d1_b[None, :]
    corr = torch.minimum(dxy, d2_b[None, :]) - m1
    return base, corr


def _swap_batch_stats(dxy, d1_b, d2_b, a_b, w, k: int, lead_g=None):
    """Per-arm sums, square-sums and leader cross-sums over a reference
    batch, each ``[k, n]``.

    g = base + 1[assign==c]·corr  ⇒
      Σ g        = Σ base + Σ_{y∈C_c} corr
      Σ g²       = Σ base² + Σ_{y∈C_c} (2·base·corr + corr²)
      Σ g·g_lead = Σ base·g_lead + Σ_{y∈C_c} corr·g_lead
    The C_c-restricted sums are one-hot products; weights are {0,1}.
    """
    base, corr = _swap_terms(dxy, d1_b, d2_b)
    base = base * w[None, :]
    # The one-hot rows by an equality (one_hot reads its input's range to
    # the host on every device but the card).
    arms = torch.arange(k, device=a_b.device)
    onehot = ((a_b.long()[:, None] == arms[None, :]).to(dxy.dtype)
              * w[:, None])                                       # [B, k]
    sums = torch.sum(base, dim=1)[None, :] + (corr @ onehot).T    # [k, n]
    sq_cross = 2.0 * base * corr + corr * corr
    sqsums = torch.sum(base * base, dim=1)[None, :] + (sq_cross @ onehot).T
    if lead_g is None:
        return sums, sqsums, torch.zeros_like(sums)
    lg = lead_g * w
    cross = (base @ lg)[None, :] + ((corr * lg[None, :]) @ onehot).T
    return sums, sqsums, cross


def _swap_lead_g(dl, d1_b, d2_b, assign_b, m_l) -> torch.Tensor:
    """The SWAP leader arm's g-row over a batch from its distance row
    ``dl``: ``base + 1[assign == m_l]·corr`` (unweighted); ``m_l`` a 0-d
    device index."""
    base, corr = _swap_terms(dl[None, :], d1_b, d2_b)
    return base[0] + (assign_b == m_l).to(dl.dtype) * corr[0]


def _ref_chunks(n_ref: int, chunk: int, device):
    """Index/weight tiling of [0, n_ref) into equal chunks; the tail is
    padded with index n_ref − 1 at weight 0 (the JAX ``_ref_chunks``)."""
    n_chunks = -(-n_ref // chunk)
    idx = torch.arange(n_chunks * chunk, device=device)
    w = (idx < n_ref).to(torch.float32)
    idx = torch.clamp_max(idx, n_ref - 1)
    return idx.view(n_chunks, chunk), w.view(n_chunks, chunk)


def _stream_walk(x, y, w, tile_fn, out_shape, tile: int = _EXACT_CHUNK):
    """Walk the reference rows ``y`` in ``tile``-row tiles (tail padded at
    weight 0, folded with the caller's weights ``w``) for every strip of
    ``_STREAM_ROWS`` rows of ``x``; each tile's three statistics
    ``tile_fn(x_strip, tile_idx, tile_w)`` are added to the strip's
    running sums in walk order."""
    m = x.shape[0]
    idx, wt = _ref_chunks(y.shape[0], tile, x.device)
    if w is not None:
        wt = wt * w[idx]
    outs = [torch.empty(out_shape(m), dtype=torch.float32, device=x.device)
            for _ in range(3)]
    # tracecheck: ignore[TRC002] -- the plain exact pass's row strips, a count
    # fixed by n (the "cuda" backend runs the whole walk as one stream kernel
    # launch)
    for r0 in range(0, m, _STREAM_ROWS):
        xt = x[r0:r0 + _STREAM_ROWS]
        acc = None
        # tracecheck: ignore[TRC002] -- the plain walk's reference tiles, fixed
        # by n / 512
        for c in range(idx.shape[0]):
            part = tile_fn(xt, idx[c], wt[c])
            acc = part if acc is None else [a + p for a, p in zip(acc, part)]
        # tracecheck: ignore[TRC002] -- the three statistics' outputs
        for o, a in zip(outs, acc):
            o[..., r0:r0 + _STREAM_ROWS] = a
    return tuple(outs)


def _stream_build_stats(x, y, dnear, w, lead_g, metric: str):
    """Streaming BUILD statistics over the whole reference set ``y``:
    (Σg, Σg², Σg·g_lead), [m] each, only one [strip, tile] block live."""
    def tile_fn(xt, i, wc):
        g = _build_g(pairwise(xt, y[i], metric=metric), dnear[i]) * wc[None, :]
        cross = (torch.zeros((xt.shape[0],), dtype=g.dtype, device=g.device)
                 if lead_g is None else g @ lead_g[i])
        return [torch.sum(g, dim=1), torch.sum(g * g, dim=1), cross]
    return _stream_walk(x, y, w, tile_fn, lambda m: (m,))


def _stream_swap_stats(x, y, d1, d2, assign, w, k: int, lead_g,
                       metric: str):
    """Streaming SWAP statistics over the whole reference set ``y``:
    (Σg, Σg², Σg·g_lead), [k, m] each, one [strip, tile] block live."""
    def tile_fn(xt, i, wc):
        return list(_swap_batch_stats(
            pairwise(xt, y[i], metric=metric), d1[i], d2[i], assign[i], wc,
            k, None if lead_g is None else lead_g[i]))
    return _stream_walk(x, y, w, tile_fn, lambda m: (k, m))


def _skipped_on_host(run: Optional[torch.Tensor]) -> bool:
    """A run flag of 0 on the CPU, where the host reads it without waiting
    for a device: the plain pass it guards is skipped there.  A flag on
    a device is never read; its kernels return at once instead.  The read
    is made on purpose, so it runs inside :func:`syncs_allowed`."""
    if run is None or run.device.type != "cpu":
        return False
    with syncs_allowed(run.device):
        return not bool(run)


def exact_build_means(be, data, dnear, *, metric: str,
                      run: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact BUILD objective over the full reference set (Algorithm 1
    lines 13–15, and PAM's BUILD step): per-arm mean g, [n].  One
    streaming pass through the backend; the division is tensor by
    tensor.  ``run`` is the device-resident search's fallback flag: where
    it reads 0 the result is for the caller to discard."""
    n = data.shape[0]
    if _skipped_on_host(run):
        return torch.zeros((n,), dtype=torch.float32)
    return be.stream_build_sums(data, dnear, metric=metric,
                                run=run) / torch.full(
        (), float(n), dtype=torch.float32, device=data.device)


def exact_swap_means(be, data, d1, d2, assign, k: int, *, metric: str,
                     run: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact SWAP objective over the flattened (medoid, candidate) arm
    set: per-arm mean g, [k·n]; the same streaming form and ``run`` as
    :func:`exact_build_means`."""
    n = data.shape[0]
    if _skipped_on_host(run):
        return torch.zeros((k * n,), dtype=torch.float32)
    return be.stream_swap_sums(data, d1, d2, assign, k, metric=metric,
                               run=run) / torch.full(
        (), float(n), dtype=torch.float32, device=data.device)


def stream_columns(be, data: torch.Tensor, refs: torch.Tensor, *,
                   metric: str,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``[n, C]`` cache column block ``d(data, refs)`` (warm block,
    PIC warm rounds), produced in row strips of ``_EXACT_CHUNK`` rows
    through the backend's pairwise path so only one ``[strip, C]`` block
    is live besides the product; the last strip is realigned to end at
    row n, as in the JAX package.  ``out`` (e.g. a column slice of the
    ring) takes the product in place."""
    tile = _EXACT_CHUNK
    n = data.shape[0]
    if out is None:
        out = torch.empty((n, refs.shape[0]), dtype=torch.float32,
                          device=data.device)
    if n <= tile:
        out.copy_(be.pairwise(data, refs, metric=metric))
        return out
    for i in range(-(-n // tile)):
        lo = min(i * tile, n - tile)
        out[lo:lo + tile] = be.pairwise(data[lo:lo + tile], refs,
                                        metric=metric)
    return out


def _top2_block(dmat: torch.Tensor):
    """Nearest / second-nearest of one distance block: d1 the minimum,
    assign the FIRST index attaining it, d2 the minimum over the other
    columns (+inf when k == 1)."""
    assign = torch.argmin(dmat, dim=1)
    d1 = torch.gather(dmat, 1, assign[:, None])[:, 0]
    cols = torch.arange(dmat.shape[1], device=dmat.device)
    d2 = torch.min(torch.where(cols[None, :] == assign[:, None],
                               float("inf"), dmat), dim=1).values
    return d1, d2, assign.to(torch.int32)


def _stream_top2(x, med_pts, metric: str, tile: int = _EXACT_CHUNK):
    """Top-2 over row tiles: only one ``[tile, k]`` block is live."""
    n = x.shape[0]
    d1 = torch.empty((n,), dtype=torch.float32, device=x.device)
    d2 = torch.empty_like(d1)
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    # tracecheck: ignore[TRC002] -- the plain top-2's row tiles, fixed by n /
    # 512 (the "cuda" backend: one top2 launch)
    for lo in range(0, n, tile):
        d1[lo:lo + tile], d2[lo:lo + tile], assign[lo:lo + tile] = (
            _top2_block(pairwise(x[lo:lo + tile], med_pts, metric=metric)))
    return d1, d2, assign


def medoid_cache(data: torch.Tensor, medoids: torch.Tensor, *, metric: str,
                 backend="torch"):
    """d1 (nearest-medoid dist), d2 (second nearest), assignment; [n]
    each — one top-2 pass through the backend (a name, or a fit's bound
    backend, ``FitContext.stats``)."""
    return get_stats_backend(backend).top2(data, data[medoids],
                                           metric=metric)


def total_loss(data: torch.Tensor, medoids: torch.Tensor, *, metric: str,
               backend="torch") -> torch.Tensor:
    """Sum of nearest-medoid dissimilarities, a 0-d float32 tensor on the
    data's device.  The final sum runs over the intact ``[n]`` vector, as
    in the JAX package."""
    d1, _, _ = medoid_cache(data, medoids, metric=metric, backend=backend)
    return torch.sum(d1)


@contextlib.contextmanager
def syncs_allowed(device):
    """Lifts ``torch.cuda``'s sync debug mode, on a CUDA ``device``, for a
    sync the driver makes on purpose (a read, the end of a timed phase),
    and puts it back after."""
    mode = (torch.cuda.get_sync_debug_mode()
            if torch.device(device).type == "cuda" else 0)
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def phase_sync(device) -> None:
    """The end of a timed phase on a CUDA ``device``: a synchronisation
    made on purpose, so it lifts the sync debug mode
    (:func:`syncs_allowed`); nothing on the CPU."""
    if torch.device(device).type == "cuda":
        with syncs_allowed(device):
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def host_stage(reason: str):
    """The sanctioned host-to-device staging span (counterpart of
    ``repro.core.engine.host_stage``): an input upload before a fit's
    first round, e.g. the data, the warm-start medoids, a predict's
    medoid rows (its queries go through a pinned buffer without a wait:
    ``repro_torch.api.predict``).  The ``reason`` is mandatory: every
    span names why it exists.  Inside it ``torch.cuda``'s sync debug mode is lifted
    (:func:`syncs_allowed`), so the upload's copy from pageable memory,
    which waits for the device, passes a fit run under
    ``set_sync_debug_mode("error")``; everything outside stays at the
    caller's level.  A table uploaded inside the rounds takes
    ``pic_cache.to_device`` (pinned memory, no wait) and no span."""
    if not reason:
        raise ValueError("host_stage requires a non-empty reason")
    with syncs_allowed("cuda" if torch.cuda.is_available() else "cpu"):
        yield


def host_read(values, report=None, phase: str = "") -> list:
    """The one device-to-host read point of the fit drivers (counterpart
    of ``repro.core.engine.host_read``).

    ``values`` are tensors on one device; they come back in ONE copy (one
    ``tolist`` of their concatenation: in their own type where they share
    one, else in int64, or in float64 where one is floating, which holds
    every float32 and every integer below 2**53 exactly), as Python ints
    for integer and bool tensors and floats otherwise, a list for a tensor
    of several elements.  Each call adds one to
    ``report.host_reads_by_phase[phase]`` when a report is given: the
    count of the reads that wait for the device.  It is the drivers' one
    deliberate sync, so it lifts ``torch.cuda``'s sync debug mode around
    its copy (:func:`syncs_allowed`): a fit run under
    ``set_sync_debug_mode("error")`` raises at any other sync.
    """
    flat = [torch.as_tensor(v).reshape(-1) for v in values]
    common = (torch.float64 if any(t.dtype.is_floating_point for t in flat)
              else torch.int64)
    if len({t.dtype for t in flat}) == 1:
        common = flat[0].dtype
    with syncs_allowed(flat[0].device):
        host = torch.cat([t.to(common) for t in flat]).tolist()
    if report is not None:
        reads = report.host_reads_by_phase
        reads[phase] = reads.get(phase, 0) + 1
    out, i = [], 0
    for t, v in zip(values, flat):
        conv = float if t.dtype.is_floating_point else int
        part = [conv(x) for x in host[i:i + v.numel()]]
        out.append(part if t.dim() else part[0])
        i += v.numel()
    return out


# ---------------------------------------------------------------------------
# Lanes: a batch of independent fits padded to one shape (fit_batch)
# ---------------------------------------------------------------------------

# Lane row stride granule: every lane's slice starts 64 bytes past the
# previous one's start, so a lane's rows and its [n_pad] vectors share the
# alignment of a fresh allocation's (the vectorised loads of the plain
# reductions and GEMMs see the layout a single fit gives them).
LANE_ROW_GRANULE = 16


@dataclasses.dataclass
class LaneData:
    """L datasets padded to ``data`` ``[L, n_pad, d]`` (zero rows past
    each lane's ``ns[l]``), with ``rows`` ``[L]`` int32 (the same counts)
    and ``base`` ``[L]`` int64 (each lane's first row in ``flat``) on the
    data's device."""

    data: torch.Tensor
    ns: list
    rows: torch.Tensor
    base: torch.Tensor

    @classmethod
    def pad(cls, arrays, device) -> "LaneData":
        """Pad ``[n_i, d]`` float32 tensors on ``device`` to one lane
        tensor whose lane stride is a multiple of ``LANE_ROW_GRANULE``."""
        ns = [int(a.shape[0]) for a in arrays]
        g = LANE_ROW_GRANULE
        n_pad = -(-max(ns) // g) * g
        data = torch.zeros((len(arrays), n_pad, arrays[0].shape[1]),
                           dtype=torch.float32, device=device)
        for i, a in enumerate(arrays):
            data[i, :ns[i]] = a
        lanes = torch.arange(len(ns), device=device)
        return cls(data=data, ns=ns,
                   rows=to_device(ns, torch.int32, device),
                   base=lanes * n_pad)

    @property
    def n_pad(self) -> int:
        return self.data.shape[1]

    @property
    def flat(self) -> torch.Tensor:
        return self.data.view(-1, self.data.shape[2])

    def lane(self, i: int) -> torch.Tensor:
        """Lane ``i``'s own ``[n_i, d]`` rows (a view)."""
        return self.data[i, :self.ns[i]]

    def groups(self):
        """``(n, [lanes])`` for each distinct n, in first-lane order."""
        out: Dict[int, list] = {}
        for i, n in enumerate(self.ns):
            out.setdefault(n, []).append(i)
        return list(out.items())

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """The rows ``idx`` ``[L, m]`` of each lane: ``[L, m, d]``."""
        g = (idx + self.base[:, None]).reshape(-1)
        return self.flat.index_select(0, g).view(idx.shape[0], idx.shape[1],
                                                 -1)


class LaneBlocks(NamedTuple):
    """Each lane's ``[n_l, b]`` block of distances in a lane ring
    ``store`` ``[L, n_pad, C]``: lane l's at columns ``[col[l], col[l] +
    b)`` (``col`` host ints, ``col_dev`` the same ``[L]`` int64 on the
    device, or None where every offset is 0)."""
    store: torch.Tensor
    col: list
    col_dev: Optional[torch.Tensor]
    b: int

    def lane(self, i: int, n: int) -> torch.Tensor:
        return self.store[i, :n, self.col[i]:self.col[i] + self.b]

    def stacked(self) -> torch.Tensor:
        """Every lane's ``[n_pad, b]`` block, ``[L, n_pad, b]``: a view
        where the lanes share one offset."""
        c = self.col[0]
        if all(v == c for v in self.col):
            return self.store[:, :, c:c + self.b]
        return torch.stack([self.store[i, :, v:v + self.b]
                            for i, v in enumerate(self.col)])


def _lane_out(lanes: LaneData, parts, arms: int):
    """Stack per-lane results (``parts[l]`` of ``arms·n_l`` arms, arm
    ``(c, x)`` at ``c·n_l + x``) into ``[L, arms·n_pad]`` zeros."""
    L, n_pad = len(lanes.ns), lanes.n_pad
    dev = lanes.data.device
    outs = []
    # tracecheck: ignore[TRC002] -- the three statistics' outputs
    for q in range(3):
        o = torch.zeros((L, arms, n_pad), dtype=torch.float32, device=dev)
        # tracecheck: ignore[TRC002] -- the plain backend's lanes, fixed by the
        # batch (the "cuda" backend launches once for every lane)
        for i, n in enumerate(lanes.ns):
            o[i, :, :n] = parts[i][q].view(arms, n)
        outs.append(o.view(L, arms * n_pad))
    return tuple(outs)


class _LaneLoop:
    """The lane forms as a loop of the backend's single forms over each
    lane's own slice, so lane l's values are the single form's bits."""

    def build_stats_lanes(self, lanes, ref_idx, dnear_b, w, lead, *, metric,
                          run=None):
        parts = [self.build_stats(lanes.lane(i), ref_idx[i], dnear_b[i],
                                  w[i], None if lead is None else lead[i],
                                  metric=metric)
                 for i in range(len(lanes.ns))]
        return _lane_out(lanes, parts, 1)

    def swap_stats_lanes(self, lanes, ref_idx, d1_b, d2_b, assign_b, w, k,
                         lead, *, metric, run=None):
        parts = []
        # tracecheck: ignore[TRC002] -- the plain backend's lane form: the
        # single form once a lane, fixed by the batch (the "cuda" backend
        # launches once)
        for i, n in enumerate(lanes.ns):
            lead_i = None
            if lead is not None:
                # Arm (c, x) is c·n_pad + x in the batch, c·n_i + x alone.
                lead_i = lead[i] // lanes.n_pad * n + lead[i] % lanes.n_pad
            parts.append(self.swap_stats(lanes.lane(i), ref_idx[i], d1_b[i],
                                         d2_b[i], assign_b[i], w[i], k,
                                         lead_i, metric=metric))
        return _lane_out(lanes, parts, k)

    def build_stats_from_d_lanes(self, lanes, blocks, dnear_b, w, lead):
        parts = [self.build_stats_from_d(blocks.lane(i, n), dnear_b[i], w[i],
                                         None if lead is None else lead[i])
                 for i, n in enumerate(lanes.ns)]
        return _lane_out(lanes, parts, 1)

    def swap_stats_from_d_lanes(self, lanes, blocks, d1_b, d2_b, assign_b,
                                w, k, lead, run=None):
        zero = (torch.zeros((k * n,), dtype=torch.float32,
                            device=lanes.data.device) for n in lanes.ns)
        parts = []
        # tracecheck: ignore[TRC002] -- the plain backend's lane form: the
        # single form once a lane, fixed by the batch (the "cuda" backend
        # launches once)
        for i, (n, z) in enumerate(zip(lanes.ns, zero)):
            if _skipped_on_host(None if run is None else run[i:i + 1]):
                parts.append((z, z, z))
                continue
            lead_i = None
            if lead is not None:
                lead_i = lead[i] // lanes.n_pad * n + lead[i] % lanes.n_pad
            parts.append(self.swap_stats_from_d(blocks.lane(i, n), d1_b[i],
                                                d2_b[i], assign_b[i], w[i], k,
                                                lead_i))
        return _lane_out(lanes, parts, k)

    def top2_lanes(self, lanes, med_idx, *, metric, live=None):
        L, n_pad = len(lanes.ns), lanes.n_pad
        dev = lanes.data.device
        d1 = torch.zeros((L, n_pad), dtype=torch.float32, device=dev)
        d2 = torch.zeros_like(d1)
        assign = torch.zeros((L, n_pad), dtype=torch.int32, device=dev)
        # tracecheck: ignore[TRC002] -- the plain backend's lane form: the
        # single form once a lane, fixed by the batch (the "cuda" backend
        # launches once)
        for i, n in enumerate(lanes.ns):
            x = lanes.lane(i)
            d1[i, :n], d2[i, :n], assign[i, :n] = self.top2(
                x, x[med_idx[i]], metric=metric)
        return d1, d2, assign


# ---------------------------------------------------------------------------
# StatsBackend implementations
# ---------------------------------------------------------------------------

class TorchStatsBackend(_LaneLoop):
    """Plain PyTorch statistics: any kernel metric, any device."""

    name = "torch"

    def bind(self, tiles: Optional[TileConfig]) -> "TorchStatsBackend":
        """The plain versions take no tile."""
        return self

    def pairwise(self, x, y, *, metric, out=None, run=None):
        return pairwise_plain(x, y, metric, out, run)

    def pairwise_lanes(self, x, y, *, metric, out=None, col=None,
                       xrows=None, yrows=None, run=None):
        return pairwise_lanes_plain(x, y, metric, out, col, xrows, yrows,
                                    run)

    def build_stats(self, data, ref_idx, dnear_b, w, lead, *, metric,
                    run=None):
        # ``run`` (a masked round's flag) changes nothing here: the plain
        # math runs and the search discards a masked round's result.
        return self.build_stats_from_d(
            pairwise(data, data.index_select(0, ref_idx), metric=metric),
            dnear_b, w, lead)

    def build_stats_from_d(self, dxy, dnear_b, w, lead):
        # The leader's g-row is a row of the g block (the jnp backend's
        # ``g @ g[lead]``).
        g = _build_g(dxy, dnear_b) * w[None, :]
        cross = (torch.zeros((g.shape[0],), dtype=g.dtype, device=g.device)
                 if lead is None
                 else g @ g.index_select(0, lead.view(1))[0])
        return torch.sum(g, dim=1), torch.sum(g * g, dim=1), cross

    def swap_stats(self, data, ref_idx, d1_b, d2_b, assign_b, w, k, lead,
                   *, metric, run=None):
        return self.swap_stats_from_d(
            pairwise(data, data.index_select(0, ref_idx), metric=metric),
            d1_b, d2_b, assign_b, w, k, lead)

    def swap_stats_from_d(self, dxy, d1_b, d2_b, assign_b, w, k, lead,
                          run=None):
        lead_g = None
        if lead is not None:
            n = dxy.shape[0]
            dl = dxy.index_select(0, (lead % n).view(1))[0]
            lead_g = _swap_lead_g(dl, d1_b, d2_b, assign_b, lead // n)
        s, q, c = _swap_batch_stats(dxy, d1_b, d2_b, assign_b, w, k, lead_g)
        return s.reshape(-1), q.reshape(-1), c.reshape(-1)

    def stream_build_sums(self, data, dnear, *, metric, run=None):
        return _stream_build_stats(data, data, dnear, None, None, metric)[0]

    def stream_swap_sums(self, data, d1, d2, assign, k, *, metric,
                         rows=None, run=None):
        x = data if rows is None else data.index_select(0, rows)
        return _stream_swap_stats(x, data, d1, d2, assign, None, k, None,
                                  metric)[0].reshape(-1)

    def top2(self, x, med_pts, *, metric):
        return _stream_top2(x, med_pts, metric)


class CudaStatsBackend:
    """The hand-written kernels: ``build_g`` / ``swap_g`` for the bandit
    rounds, ``swap_g_from_cache`` for SWAP rounds served from a resident
    distance block and the carried-moment repair, ``stream_build_g`` /
    ``stream_swap_g`` for the exact passes, ``top2`` for the medoid cache,
    loss and labels, ``pairwise`` for the BUILD ``d_near`` update, the
    leader's distance row, the PIC ring's fresh columns and predict.
    CUDA tensors only.  BUILD statistics from a resident block are the
    torch backend's plain math (no distance work to fuse).

    The kernels take the leader's g-row as an input, so under
    ``baseline="leader"`` it comes from one extra pairwise row of the
    leader against the batch (the Pallas backend's way): an O(B·d) add
    that the ledger does not count, as in the JAX package.

    ``tiles`` (a :class:`~repro_torch.core.tuning.TileConfig`) is the
    shape of every launch: a fit resolves it once and runs on
    :meth:`bind`'s copy (``FitContext.stats``); the registry's instance
    has None, and each launch resolves through the tuner."""

    name = "cuda"

    def __init__(self, tiles: Optional[TileConfig] = None):
        self.tiles = tiles
        t = tiles
        self._pw = ({} if t is None else {"tm": t.tm, "tr": t.tr})
        self._rows = ({} if t is None else {"tm": t.tm})
        self._top2 = ({} if t is None else {"tr": t.tk})

    def bind(self, tiles: Optional[TileConfig]) -> "CudaStatsBackend":
        """This backend with every launch in ``tiles``."""
        return type(self)(tiles)

    @staticmethod
    def _ops(t: torch.Tensor):
        if not t.is_cuda:
            raise ValueError(f"the 'cuda' stats backend takes CUDA tensors, "
                             f"got {t.device}; use backend='torch'")
        from ..kernels import ops
        return ops

    def pairwise(self, x, y, *, metric, out=None, run=None):
        return self._ops(x).pairwise_distance(x, y, metric, out=out, run=run,
                                              **self._pw)

    def build_stats(self, data, ref_idx, dnear_b, w, lead, *, metric,
                    run=None):
        ops = self._ops(data)
        y = data.index_select(0, ref_idx)
        lead_g = None
        if lead is not None:
            dl = ops.pairwise_distance(data.index_select(0, lead.view(1)), y,
                                       metric, **self._pw)[0]
            lead_g = _build_g(dl[None, :], dnear_b)[0] * w
        return ops.build_g_stats(data, y, dnear_b, w, lead_g, metric=metric,
                                 run=run, **self._rows)

    def swap_stats(self, data, ref_idx, d1_b, d2_b, assign_b, w, k, lead,
                   *, metric, run=None):
        ops = self._ops(data)
        y = data.index_select(0, ref_idx)
        lead_g = None
        if lead is not None:
            n = data.shape[0]
            dl = ops.pairwise_distance(
                data.index_select(0, (lead % n).view(1)), y, metric,
                **self._pw)[0]
            lead_g = _swap_lead_g(dl, d1_b, d2_b, assign_b, lead // n)
        s, q, c = ops.swap_g_stats(data, y, d1_b, d2_b, assign_b, w, k,
                                   lead_g, metric=metric, run=run,
                                   **self._rows)
        return s.reshape(-1), q.reshape(-1), c.reshape(-1)

    def build_stats_from_d(self, dxy, dnear_b, w, lead):
        self._ops(dxy)
        return TorchStatsBackend.build_stats_from_d(self, dxy, dnear_b, w,
                                                    lead)

    def swap_stats_from_d(self, dxy, d1_b, d2_b, assign_b, w, k, lead,
                          run=None):
        ops = self._ops(dxy)
        lead_g = None
        if lead is not None:
            # The leader's distance row is a row of the block.
            n = dxy.shape[0]
            dl = dxy.index_select(0, (lead % n).view(1))[0]
            lead_g = _swap_lead_g(dl, d1_b, d2_b, assign_b, lead // n)
        s, q, c = ops.swap_g_stats_cached(dxy, d1_b, d2_b, assign_b, w, k,
                                          lead_g, run=run)
        return s.reshape(-1), q.reshape(-1), c.reshape(-1)

    def stream_build_sums(self, data, dnear, *, metric, run=None):
        return self._ops(data).stream_build_g_stats(data, data, dnear,
                                                    metric=metric, run=run,
                                                    **self._rows)[0]

    def stream_swap_sums(self, data, d1, d2, assign, k, *, metric,
                         rows=None, run=None):
        x = data if rows is None else data.index_select(0, rows)
        return self._ops(data).stream_swap_g_stats(
            x, data, d1, d2, assign, k=k, metric=metric, run=run,
            moments=False, **self._rows)[0].reshape(-1)

    def top2(self, x, med_pts, *, metric):
        return self._ops(x).stream_top2(x, med_pts, metric=metric,
                                        **self._top2)

    # -- the lane forms: one launch a round for every lane ---------------
    # A lane round's leader row: each lane's leader against its own batch,
    # the diagonal blocks of one pairwise launch per LEAD_GROUP lanes
    # (the kernels give a pair the same bits at every shape).
    LEAD_GROUP = 64

    def _lead_rows(self, ops, lanes, lead_rows, y, metric):
        L, b = y.shape[0], y.shape[1]
        pts = lanes.flat.index_select(0, lead_rows + lanes.base)
        out = []
        # tracecheck: ignore[TRC002] -- one pairwise launch a group of
        # LEAD_GROUP = 64 lanes, a count fixed by the batch
        for lo in range(0, L, self.LEAD_GROUP):
            hi = min(lo + self.LEAD_GROUP, L)
            blk = ops.pairwise_distance(
                pts[lo:hi], y[lo:hi].reshape((hi - lo) * b, -1), metric,
                **self._pw)
            diag = torch.arange(hi - lo, device=y.device)
            out.append(blk.view(hi - lo, hi - lo, b)[diag, diag])
        return out[0] if len(out) == 1 else torch.cat(out)

    def build_stats_lanes(self, lanes, ref_idx, dnear_b, w, lead, *, metric,
                          run=None):
        ops = self._ops(lanes.data)
        y = lanes.gather(ref_idx)
        lead_g = None
        if lead is not None:
            dl = self._lead_rows(ops, lanes, lead, y, metric)
            lead_g = torch.where(torch.isinf(dnear_b), dl,
                                 torch.clamp_max(dl - dnear_b, 0.0)) * w
        return ops.build_g_lanes_stats(lanes.data, y, dnear_b, w, lead_g,
                                       rows=lanes.rows, metric=metric,
                                       run=run, **self._rows)

    def swap_stats_lanes(self, lanes, ref_idx, d1_b, d2_b, assign_b, w, k,
                         lead, *, metric, run=None):
        ops = self._ops(lanes.data)
        y = lanes.gather(ref_idx)
        lead_g = None
        if lead is not None:
            n_pad = lanes.n_pad
            dl = self._lead_rows(ops, lanes, lead % n_pad, y, metric)
            m1 = torch.minimum(dl, d1_b)
            corr = torch.minimum(dl, d2_b) - m1
            lead_g = (m1 - d1_b) + (assign_b == (lead // n_pad)[:, None]).to(
                dl.dtype) * corr
        s, q, c = ops.swap_g_lanes_stats(lanes.data, y, d1_b, d2_b, assign_b,
                                         w, k, lead_g, rows=lanes.rows,
                                         metric=metric, run=run,
                                         **self._rows)
        L = y.shape[0]
        return s.view(L, -1), q.view(L, -1), c.view(L, -1)

    def pairwise_lanes(self, x, y, *, metric, out=None, col=None,
                       xrows=None, yrows=None, run=None):
        return self._ops(x).pairwise_lanes(x, y, metric, out=out, col=col,
                                           xrows=xrows, yrows=yrows, run=run,
                                           **self._pw)

    def build_stats_from_d_lanes(self, lanes, blocks, dnear_b, w, lead):
        # The single form's plain math with a lane axis: elementwise ops and
        # row sums over B, each lane's bits those of the single [n, B]
        # call; the leader's cross sums are one matrix-vector product per
        # lane, as the single form's.
        self._ops(lanes.data)
        dxy = blocks.stacked()
        dn = dnear_b[:, None, :]
        g = torch.where(torch.isinf(dn), dxy,
                        torch.clamp_max(dxy - dn, 0.0)) * w[:, None, :]
        sums, sq = torch.sum(g, dim=2), torch.sum(g * g, dim=2)
        if lead is None:
            return sums, sq, torch.zeros_like(sums)
        lg = g.gather(1, lead.view(-1, 1, 1).expand(-1, 1, g.shape[2]))
        cross = torch.zeros_like(sums)
        # tracecheck: ignore[TRC002] -- one matrix-vector product a lane (the
        # single form's bits), a count fixed by the batch
        for i, n in enumerate(lanes.ns):
            torch.mv(g[i, :n], lg[i, 0], out=cross[i, :n])
        return sums, sq, cross

    def swap_stats_from_d_lanes(self, lanes, blocks, d1_b, d2_b, assign_b,
                                w, k, lead, run=None):
        ops = self._ops(lanes.data)
        lead_g = None
        if lead is not None:
            # The leader's distance row is a row of its lane's block.
            n_pad = lanes.n_pad
            L = d1_b.shape[0]
            cols = torch.arange(blocks.b, device=d1_b.device).expand(L, -1)
            if blocks.col_dev is not None:
                cols = cols + blocks.col_dev[:, None]
            row = blocks.store[torch.arange(L, device=cols.device),
                               lead % n_pad]
            dl = row.gather(1, cols)
            m1 = torch.minimum(dl, d1_b)
            corr = torch.minimum(dl, d2_b) - m1
            lead_g = (m1 - d1_b) + (assign_b == (lead // n_pad)[:, None]).to(
                dl.dtype) * corr
        s, q, c = ops.swap_g_from_cache_lanes_stats(
            blocks.store, d1_b, d2_b, assign_b, w, k, lead_g,
            col=blocks.col_dev, rows=lanes.rows, run=run)
        L = d1_b.shape[0]
        return s.view(L, -1), q.view(L, -1), c.view(L, -1)

    def top2_lanes(self, lanes, med_idx, *, metric, live=None):
        ops = self._ops(lanes.data)
        rows = (lanes.rows if live is None
                else torch.where(live, lanes.rows, 0).to(torch.int32))
        return ops.stream_top2_lanes(lanes.data, lanes.gather(med_idx),
                                     rows=rows, metric=metric, **self._top2)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Any] = {}


def register_stats_backend(name: str, backend) -> None:
    """Register a stats backend instance under ``name``."""
    _BACKENDS[name] = backend


def get_stats_backend(name):
    """The backend registered as ``name``; a backend instance (a fit's
    bound one) is returned as it is."""
    if not isinstance(name, str):
        return name
    if name not in _BACKENDS:
        raise KeyError(f"unknown stats backend {name!r}; "
                       f"have {sorted(_BACKENDS)}")
    return _BACKENDS[name]


def available_stats_backends():
    return sorted(_BACKENDS)


register_stats_backend("torch", TorchStatsBackend())
register_stats_backend("cuda", CudaStatsBackend())


def resolve_stats_backend(backend: Optional[str], metric: str,
                          device: torch.device) -> str:
    """Normalise a ``backend=`` argument to a registered name.

    ``"auto"`` (or None) picks the kernels for a kernel metric on a CUDA
    device and the plain versions otherwise: on the CPU, and for a metric
    without a kernel (one added with ``register_metric``) on any device,
    CUDA included, as the reference's ``"auto"`` sends such a metric to
    ``"jnp"`` (``src/repro/core/engine.py:575-578``).  An explicit
    ``"cuda"`` off a CUDA device or with such a metric is an error.
    """
    from ..kernels.ops import KERNEL_METRICS
    on_cuda = torch.device(device).type == "cuda"
    if backend in (None, "auto"):
        return "cuda" if on_cuda and metric in KERNEL_METRICS else "torch"
    get_stats_backend(backend)  # raises KeyError for unknown names
    if backend == "cuda":
        if not on_cuda:
            raise ValueError(f"backend='cuda' needs a CUDA device, got "
                             f"{device}; use backend='torch'")
        if metric not in KERNEL_METRICS:
            raise ValueError(f"metric {metric!r} has no kernel (kernel "
                             f"metrics: {list(KERNEL_METRICS)})")
    return backend


# ---------------------------------------------------------------------------
# FitContext: one fit's cache regime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FitContext:
    """What one ``BanditPAM.fit`` threads between its phases (the JAX
    package's single-fit fields; a batch's lanes are :class:`LaneData`).

    ``mode`` is the cache regime:

    * ``"none"``: no distance cache; every round is fresh and every
      search draws its own permutation (or replacement batches);
    * ``"warm"`` (paper App 2.2): one fixed permutation for every search
      and a block ``dwarm`` [n, C] of its first ``free_rounds`` rounds'
      columns, computed once up front; later rounds are fresh;
    * ``"pic"`` (BanditPAM++): one fixed permutation and the bounded
      column ring ``cache`` (:class:`~repro_torch.core.pic_cache.PicCache`,
      capacity ``W = cols.shape[1] // B``), written through by the
      rounds that compute a block fresh; ``perm_idx`` / ``perm_w`` are the
      permutation's cyclic tiling at the ring's width, read by the
      carried-moment repair.

    ``tiles`` is the fit's :class:`~repro_torch.core.tuning.TileConfig`,
    resolved once (``tuning.resolve_tile_config``), and ``stats`` the
    backend bound to it, which every phase of the fit launches through.
    """

    mode: str                                 # "none" | "warm" | "pic"
    backend: str                              # registered stats backend
    perm: Optional[torch.Tensor] = None       # [n] fixed permutation
    perm_idx: Optional[torch.Tensor] = None   # [W·B] tiled prefix ("pic")
    perm_w: Optional[torch.Tensor] = None     # [W·B] {0,1} weights ("pic")
    cache: Optional[PicCache] = None          # the ring ("pic")
    dwarm: Optional[torch.Tensor] = None      # [n, C] warm block ("warm")
    free_rounds: int = 0                      # rounds in dwarm ("warm")
    tiles: Optional[TileConfig] = None        # the fit's resolved tiles
    stats: Any = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.stats = bind_stats_backend(self.backend, self.tiles)


def bind_stats_backend(name, tiles: Optional[TileConfig]):
    """The backend ``name`` with every launch in ``tiles`` (a backend
    without ``bind``, registered by a user, as it is)."""
    be = get_stats_backend(name)
    bind = getattr(be, "bind", None)
    return be if bind is None or tiles is None else bind(tiles)
