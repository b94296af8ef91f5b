"""Peak-memory budgets of the port's entry points (counterpart of
``repro/analysis/graph/budgets.py``), and their measure on the card.

One place declares, for each budgeted entry point, the bytes of
temporaries it may hold at canonical shapes.  The JAX package bounds
XLA's ``memory_analysis().temp_size_in_bytes`` of the compiled program;
the port's counterpart is :func:`measure_temp_bytes`: the peak of
``torch.cuda.max_memory_allocated`` over the call above what was
allocated before it, less the bytes of the tensors the call returns.

Budget semantics are the JAX module's: every bound is an O(n·tile)-class
formula of the shapes, never a measured value plus slack.  The
streaming entry points are bounded by a tenth of the block their
pre-streaming form held ([n, k] for the loss and the cache, [n, 512] for
the exact fallback), so a revert to that form overshoots by 10x; the
PIC fit's phases by their ring working set.  Where the port holds a
buffer that the JAX graph does not, the port's bound adds that buffer's
size, written from the shapes, the tile and the card's slot count, and
:func:`budget_doc` names it: the bin scratch of the ``swap_g`` kernel
(``kernels/csrc/swap_g.cu``), which a reference tile wider than one
104-column tile needs, one ``[4][4][3][k][32]``-float block a resident
slot (``stream_swap_g``).  It is allocated by PyTorch's allocator
(``kernels.swap_g.bin_scratch``), so the measure sees it.

Each key names the port's entry point; :func:`counterpart` gives the JAX
key it carries over (``api.get_predict_fn`` is ``api.medoid_distances``
here, ``core._build_fused[pic]`` the PIC fit's BUILD phase).  The
``ops.stream_*`` keys are the port's own: the JAX bounds of its
``kernels.stream_*`` keys cover the Pallas interpret-mode emulator,
which has no counterpart on the card.  :func:`materialised_bytes` is the
bytes of the form a revert would hold, which overshoots each bound.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.tuning import REF_TILE

__all__ = ["Measure", "budget_bytes", "budget_doc", "budget_names",
           "card_buffer_bytes", "counterpart", "materialised_bytes",
           "materialised_doc", "measure", "measure_temp_bytes",
           "shape_for", "swap_scratch_bytes", "N_BIG", "D_BIG", "K_BIG",
           "ROWS_PREDICT", "ROWS_ASSIGN", "N_DRIVER", "D_DRIVER", "K_DRIVER",
           "WIDTH_DRIVER", "B_DRIVER", "CARD_SLOTS", "ROW_TILE"]

# Canonical big shapes (the JAX module's).
N_BIG, D_BIG, K_BIG = 200_000, 16, 256
# Serving: one 8k-row predict bucket, one 128k-row assign pass.
ROWS_PREDICT = 8192
ROWS_ASSIGN = 131_072
# The PIC fit's phases: moderate n, a ring of 12 rounds of B = 32.
N_DRIVER, D_DRIVER, K_DRIVER = 20_000, 8, 4
B_DRIVER = 32
WIDTH_DRIVER = 12 * B_DRIVER
# The swap_g kernel's resident slots and row tile at which the bounds
# are declared: 132 SMs x 2 blocks an SM at the 128-row tile (the
# NVIDIA H100 SXM; swap_g.cu: two blocks an SM at every k).  A
# measurement on a card passes that card's slots and the tile its launch
# took.
CARD_SLOTS = 132 * 2
ROW_TILE = 128

_F32 = 4
_SUBS = 4           # swap_g.cu's owners a row


def swap_scratch_bytes(rows: int, k: int, slots: int = CARD_SLOTS,
                       bm: int = ROW_TILE, lanes: int = 1) -> int:
    """The bin scratch of one ``swap_g`` kernel launch whose reference
    tile spans several column tiles: one block a resident slot (at most
    one a row tile), each with ``bm · 4 · 3 · k`` floats (swap_g.cu)."""
    per_lane = max(slots // lanes, 1)
    grid = min(-(-int(rows) // bm), per_lane)
    return lanes * grid * bm * _SUBS * 3 * int(k) * _F32


def _scratch(rows_key: str) -> Callable[[dict], int]:
    return lambda s: swap_scratch_bytes(s[rows_key], s["k"], s["slots"],
                                        s["bm"])


_SCRATCH_DOC = ("the bin scratch of stream_swap_g: min(ceil({r}/bm), slots)"
                "*bm*4*3*k*4 (kernels/csrc/swap_g.cu: one block a resident "
                "slot, slots = SMs x blocks an SM, 264 on the H100 at "
                "bm = 128)")


class _Budget(NamedTuple):
    formula: Callable[[dict], int]        # the bound
    doc: str
    jax_key: Optional[str]                # the JAX key it carries over
    buffer: Optional[Callable[[dict], int]]   # the port's named buffer
    materialised: Callable[[dict], int]   # a revert's bytes
    materialised_doc: str


def _nk(s):
    return s["n"] * s["k"] * _F32


def _walk(s):
    return s["n"] * REF_TILE * _F32


def _ring(s):
    return 4 * s["n"] * s["width"] * _F32


def _square(s):
    return s["n"] * s["n"] * _F32


_BUDGETS: Dict[str, _Budget] = {
    "engine.total_loss": _Budget(
        lambda s: _nk(s) // 10,
        "n*k*4 // 10  (a tenth of the materialised [n, k] block)",
        "engine.total_loss", None, _nk, "the [n, k] distance block"),
    "engine.medoid_cache": _Budget(
        lambda s: _nk(s) // 10,
        "n*k*4 // 10  (a tenth of the materialised [n, k] block)",
        "engine.medoid_cache", None, _nk, "the [n, k] distance block"),
    "engine.exact_build_means": _Budget(
        lambda s: _walk(s) // 10,
        "n*512*4 // 10  (a tenth of the pre-streaming scan temp)",
        "engine.exact_build_means", None, _walk,
        "the [n, 512] reference-tile walk held whole"),
    "engine.exact_swap_means": _Budget(
        lambda s: _nk(s) + _walk(s) // 10 + _scratch("n")(s),
        "n*k*4 + n*512*4 // 10  (the JAX bound: one [k, n] product-size "
        "staging copy + a tenth of the pre-streaming scan temp) + "
        + _SCRATCH_DOC.format(r="n"),
        "engine.exact_swap_means", _scratch("n"),
        lambda s: _nk(s) + _walk(s) + _scratch("n")(s),
        "the staging copy beside the whole [n, 512] scan block, with the "
        "bin scratch"),
    "ops.stream_build_g_stats": _Budget(
        lambda s: s["m"] * s["n"] * _F32 // 10,
        "m*n*4 // 10  (a tenth of the [m, n] distance block the kernel "
        "never holds)",
        None, None, lambda s: s["m"] * s["n"] * _F32,
        "the [m, n] distance block"),
    "ops.stream_swap_g_stats": _Budget(
        lambda s: s["m"] * s["n"] * _F32 // 10 + _scratch("m")(s),
        "m*n*4 // 10  (a tenth of the [m, n] distance block the kernel "
        "never holds) + " + _SCRATCH_DOC.format(r="m"),
        None, _scratch("m"), lambda s: s["m"] * s["n"] * _F32,
        "the [m, n] distance block"),
    "ops.stream_top2": _Budget(
        lambda s: _nk(s) // 10,
        "n*k*4 // 10  (a tenth of the [n, k] block the kernel never "
        "holds)",
        None, None, _nk, "the [n, k] distance block"),
    "api.medoid_distances": _Budget(
        lambda s: s["rows"] * s["k"] * _F32 * 2,
        "rows*k*4*2  (the returned block + one temp copy ceiling)",
        "api.get_predict_fn", None,
        lambda s: s["rows"] * s["k"] * s["d"] * _F32,
        "the [rows, k, d] broadcast difference"),
    "api.assign_medoids": _Budget(
        lambda s: s["rows"] * s["k"] * _F32 // 10,
        "rows*k*4 // 10  (a tenth of the never-materialised block)",
        "api.get_assign_fn", None, lambda s: s["rows"] * s["k"] * _F32,
        "the [rows, k] distance block"),
    "core.BanditPAM.build[pic]": _Budget(
        _ring,
        "4*n*width*4  (PIC ring working set; [n, n] would be ~13x)",
        "core._build_fused[pic]", None, _square,
        "the [n, n] ring (cache_width = n)"),
    "core.BanditPAM.swap[pic]": _Budget(
        lambda s: _ring(s) + 4 * _nk(s),
        "4*n*width*4 + 4*n*k*4  (ring + carry/cache working set; measured "
        "as a warm start, the ring and the SWAP iterations)",
        "core._swap_iter[pic]", None, _square,
        "the [n, n] ring (cache_width = n)"),
}

_SLOTS = {"slots": CARD_SLOTS, "bm": ROW_TILE}
_SHAPES: Dict[str, Dict[str, int]] = {
    "engine.total_loss": {"n": N_BIG, "d": D_BIG, "k": K_BIG},
    "engine.medoid_cache": {"n": N_BIG, "d": D_BIG, "k": K_BIG},
    "engine.exact_build_means": {"n": N_BIG, "d": D_BIG},
    "engine.exact_swap_means": {"n": N_BIG, "d": D_BIG, "k": K_BIG,
                                **_SLOTS},
    "ops.stream_build_g_stats": {"m": 256, "n": N_BIG, "d": D_BIG},
    "ops.stream_swap_g_stats": {"m": 256, "n": N_BIG, "d": D_BIG,
                                "k": K_BIG, **_SLOTS},
    "ops.stream_top2": {"n": N_BIG, "d": D_BIG, "k": K_BIG},
    "api.medoid_distances": {"rows": ROWS_PREDICT, "k": K_BIG, "d": D_BIG},
    "api.assign_medoids": {"rows": ROWS_ASSIGN, "k": K_BIG, "d": D_BIG},
    "core.BanditPAM.build[pic]": {"n": N_DRIVER, "d": D_DRIVER,
                                  "k": K_DRIVER, "width": WIDTH_DRIVER},
    "core.BanditPAM.swap[pic]": {"n": N_DRIVER, "d": D_DRIVER,
                                 "k": K_DRIVER, "width": WIDTH_DRIVER},
}


def budget_names():
    """All declared budget keys."""
    return tuple(_BUDGETS)


def shape_for(name: str) -> Dict[str, int]:
    """The canonical shape point ``name`` is budgeted at."""
    return dict(_SHAPES[name])


def _shape(name: str, shape) -> dict:
    s = shape_for(name)
    s.update(shape)
    return s


def budget_bytes(name: str, **shape) -> int:
    """The declared byte bound for ``name``, at the canonical shapes
    updated by ``shape`` (e.g. another n, or a card's ``slots`` and the
    row tile ``bm`` its launch took)."""
    return int(_BUDGETS[name].formula(_shape(name, shape)))


def budget_doc(name: str) -> str:
    """The human-readable formula behind ``budget_bytes(name)``."""
    return _BUDGETS[name].doc


def counterpart(name: str) -> Optional[str]:
    """The JAX key whose bound ``name`` carries over (None: the port's
    own bound)."""
    return _BUDGETS[name].jax_key


def card_buffer_bytes(name: str, **shape) -> int:
    """The bytes of the buffer the port's bound adds to the JAX one (0
    where it adds none)."""
    buf = _BUDGETS[name].buffer
    return 0 if buf is None else int(buf(_shape(name, shape)))


def materialised_bytes(name: str, **shape) -> int:
    """The bytes of the materialised form a revert would hold (named in
    :func:`materialised_doc`); it overshoots the bound."""
    return int(_BUDGETS[name].materialised(_shape(name, shape)))


def materialised_doc(name: str) -> str:
    return _BUDGETS[name].materialised_doc


# ---------------------------------------------------------------------------
# The measure on the card
# ---------------------------------------------------------------------------

def _returned_bytes(out, device: torch.device) -> int:
    """Bytes of the distinct storages of the device tensors in ``out``
    (tensors, or tuples, lists and dicts of them)."""
    seen, total, stack = set(), 0, [out]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device == device:
                st = v.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return total


def measure_temp_bytes(fn, *args, device=None) -> int:
    """The temporaries ``fn(*args)`` holds on the card, the counterpart of
    XLA's ``temp_size_in_bytes``: the peak of
    ``torch.cuda.max_memory_allocated`` over the call, above what was
    allocated before it, less the bytes of the device tensors the call
    returns.  ``device``: the card (default: the current one).  Raises
    without a CUDA device: the measure is of the card's allocator."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_temp_bytes measures a CUDA device's "
                           "allocator; none is available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return peak - before - _returned_bytes(out, dev)


class Measure(NamedTuple):
    """One key measured on the card: the entry point's temporaries, its
    bound at this card's slot count and the row tile its launch took, and
    the temporaries of its materialised form."""
    name: str
    temp: int
    bound: int
    materialised: int
    shape: dict


def _walk_means(data, dnear=None, cache=None, k: int = 0):
    """The exact means by the materialised walk: each 512-column
    reference tile's whole ``[n, 512]`` block at once, the plain math
    (BUILD with ``dnear``, SWAP with the medoid ``cache`` at k)."""
    from ..core.distances import pairwise
    from ..core.engine import _build_g, _swap_batch_stats
    n = data.shape[0]
    acc = None
    for lo in range(0, n, REF_TILE):
        idx = torch.arange(lo, min(lo + REF_TILE, n), device=data.device)
        dxy = pairwise(data, data.index_select(0, idx), metric="l2")
        if cache is None:
            part = torch.sum(_build_g(dxy, dnear[idx]), dim=1)
        else:
            d1, d2, a = (v[idx] for v in cache)
            part = _swap_batch_stats(dxy, d1, d2, a, torch.ones_like(d1),
                                     k)[0].reshape(-1)
        acc = part if acc is None else acc + part
    return acc / n


def _pic_phase(x, s, phase: str, width: int):
    """A factory of one phase of the PIC fit (``BanditPAM(k,
    batch_size=B_DRIVER, reuse="pic", cache_width=width)`` on ``x``, the
    ``"cuda"`` backend) with its ring, which the phase's call makes and
    frees: BUILD with the fit's context, and SWAP as a warm start from
    the cold fit's medoids (the serving layer's refit: the ring and the
    SWAP iterations, no BUILD).  The factory returns the call to
    measure."""
    import numpy as np
    from ..core import rng
    from ..core.banditpam import BanditPAM
    from ..core.report import FitReport
    est = BanditPAM(s["k"], batch_size=B_DRIVER, reuse="pic",
                    cache_width=width, backend="cuda", device=x.device)

    def build():
        layouts = rng.from_seed(est.seed, x.device, est.k)
        res = FitReport(medoids=np.zeros(est.k, np.int64), loss=np.inf)
        ctx = est._make_context(x, "cuda", layouts, res)
        _, med_t, med_mask = est._build(x, ctx, layouts, res, True)
        return med_t, med_mask

    if phase == "build":
        return lambda: build
    medoids = []

    def make():
        if not medoids:
            medoids.append(BanditPAM(s["k"], batch_size=B_DRIVER,
                                     reuse="pic", backend="cuda",
                                     device=x.device).fit(x).medoids)
        return lambda: est.fit(x, warm_start=medoids[0])
    return make


def measure(name: str, device=None, seed: int = 0) -> Measure:
    """Measure budget key ``name`` on the card at its canonical shapes
    (data made there from ``seed``, l2, the ``"cuda"`` backend, every
    launch in the tile the tuner resolves): its entry point's
    temporaries, the bound at this card's slots and that row tile, and
    the temporaries of its materialised form.  Each call runs once
    unmeasured first, so that the library's build, the tile tables and
    the allocator's pools are in place; predict's measured call then
    captures its CUDA graphs anew, so their buffers count."""
    from ..api import predict
    from ..core import engine, tuning
    from ..kernels import ops
    dev = torch.device("cuda" if device is None else device)
    s = shape_for(name)
    g = torch.Generator(device=dev).manual_seed(seed)
    kind = tuning.current_device_kind(dev)

    def points(n, d):
        return torch.randn((n, d), generator=g, device=dev)

    def medoids(n, k):
        return torch.randperm(n, generator=g, device=dev)[:k]

    def card(rows, k, d):
        """This card's slots and the row tile the launch resolves."""
        tm = tuning.resolve_tile_config(rows, d, k, kind, "cuda").tm
        per = tuning.blocks_per_sm("stream_swap_g", tuning.row_index(tm), k)
        s.update(slots=tuning.sm_count() * per, bm=tm)

    def same(fn):
        return lambda: fn

    be = engine.get_stats_backend("cuda")
    if name in ("engine.total_loss", "engine.medoid_cache",
                "ops.stream_top2"):
        x, med = points(s["n"], s["d"]), medoids(s["n"], s["k"])
        fn = {"engine.total_loss": lambda: engine.total_loss(
                  x, med, metric="l2", backend="cuda"),
              "engine.medoid_cache": lambda: engine.medoid_cache(
                  x, med, metric="l2", backend="cuda"),
              "ops.stream_top2": lambda: ops.stream_top2(
                  x, x[med], metric="l2")}[name]
        make = same(fn)
        make_mat = same(lambda: torch.min(torch.cdist(x, x[med]), dim=1))
    elif name in ("engine.exact_build_means", "engine.exact_swap_means"):
        x = points(s["n"], s["d"])
        cache = engine.medoid_cache(x, medoids(s["n"], K_BIG), metric="l2",
                                    backend="cuda")
        if name == "engine.exact_build_means":
            make = same(lambda: engine.exact_build_means(be, x, cache[0],
                                                         metric="l2"))
            make_mat = same(lambda: _walk_means(x, dnear=cache[0]))
        else:
            card(s["n"], s["k"], s["d"])
            make = same(lambda: engine.exact_swap_means(
                be, x, *cache, s["k"], metric="l2"))
            make_mat = same(lambda: _walk_means(x, cache=cache, k=s["k"]))
    elif name in ("ops.stream_build_g_stats", "ops.stream_swap_g_stats"):
        x, y = points(s["m"], s["d"]), points(s["n"], s["d"])
        d1, d2, a = engine.medoid_cache(y, medoids(s["n"], s.get("k", 1)),
                                        metric="l2", backend="cuda")
        if name == "ops.stream_build_g_stats":
            make = same(lambda: ops.stream_build_g_stats(x, y, d1,
                                                         metric="l2"))
            make_mat = same(lambda: torch.sum(engine._build_g(
                torch.cdist(x, y), d1), dim=1))
        else:
            card(s["m"], s["k"], s["d"])
            make = same(lambda: ops.stream_swap_g_stats(
                x, y, d1, d2, a, k=s["k"], metric="l2"))
            make_mat = same(lambda: engine._swap_batch_stats(
                torch.cdist(x, y), d1, d2, a, torch.ones_like(d1), s["k"]))
    elif name in ("api.medoid_distances", "api.assign_medoids"):
        q, pts = points(s["rows"], s["d"]), points(s["k"], s["d"])

        def captured(fn):
            """The call with predict's callables dropped first, so that
            it captures its graphs: their static buffers and pool, which
            stay on the card, are counted with its temporaries."""
            def factory():
                predict.clear_callables()
                return fn
            return factory
        if name == "api.medoid_distances":
            make = captured(lambda: predict.medoid_distances_t(
                q, pts, "l2", backend="cuda"))
            make_mat = same(lambda: torch.linalg.vector_norm(
                q[:, None, :] - pts[None], dim=2))
        else:
            make = captured(lambda: predict.assign_medoids(
                q, pts, "l2", backend="cuda", device=dev))
            make_mat = same(lambda: torch.min(torch.cdist(q, pts), dim=1))
    elif name in ("core.BanditPAM.build[pic]", "core.BanditPAM.swap[pic]"):
        x = points(s["n"], s["d"])
        phase = "build" if name.endswith("build[pic]") else "swap"
        make = _pic_phase(x, s, phase, s["width"])
        make_mat = _pic_phase(x, s, phase, s["n"])
    else:
        raise KeyError(f"unknown budget key {name!r}")
    # The entry point runs once first (its library, tile tables and
    # cuBLAS workspace are not its temporaries); the materialised form
    # does not need to.
    make()()
    temps = [measure_temp_bytes(factory(), device=dev)
             for factory in (make, make_mat)]
    bound = budget_bytes(name, **{k: v for k, v in s.items()
                                  if k in ("slots", "bm")})
    return Measure(name, temps[0], bound, temps[1], s)
