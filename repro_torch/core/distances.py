"""Distance registry for k-medoids, in PyTorch.

Counterpart of ``repro.core.distances``.  Every function maps a target
block ``x: [m, d]`` and a reference block ``y: [r, d]`` to ``[m, r]``
float32 dissimilarities, with the JAX package's formulas and clamps:

* ``l2sq`` is ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)`` (one matrix product plus
  rank-1 norm terms), ``l2`` its square root;
* ``cosine`` is ``1 − x̂·ŷᵀ`` with ``x̂ = x · rsqrt(max(‖x‖², 1e-30))``;
* ``l1`` is the abs-sum, evaluated in reference chunks so the
  ``[m, chunk, d]`` intermediate stays under ``2**24`` elements.

These are the plain versions of the ``pairwise`` kernel and the metric
half of the ``"torch"`` stats backend.  Their products stay in full
float32 whatever precision the process has set: on a CUDA tensor they
switch TF32 off, and on the CPU they pin oneDNN's float32 matrix
products to IEEE float32 (``torch.set_float32_matmul_precision("medium")``
or ``torch.backends.mkldnn.matmul.fp32_precision = "bf16"`` would
otherwise send them through bf16 on a CPU with AMX-BF16).

The registry is open, as in the JAX package: ``register_metric`` takes
any ``[m, d] x [r, d] -> [m, r]`` function of tensors, and
``resolve_metric`` also takes a raw callable (registered under a name
derived from it, never over an existing one) or ``"precomputed"``.  A
caller-supplied ``[n, n]`` dissimilarity matrix goes through
:func:`attach_index`, which appends each row's own index as a trailing
column; the ``"precomputed"`` metric then gathers ``D[I, J]`` for a block
pair from the x rows (full rows of D) at the y rows' index column, so
every solver runs on it unchanged.  Neither has a kernel: under
``backend="auto"`` both run on ``"torch"`` on the data's device, CUDA
included (``engine.resolve_stats_backend``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Metric = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Metric] = {}

# Keep the [m, chunk, d] L1 intermediate under ~2**24 elements.
_L1_CHUNK_ELEMS = 1 << 24


def full_fp32(t: torch.Tensor) -> None:
    """Keep a float32 product in full float32 on the tensor's device:
    TF32 off on the card, oneDNN's float32 matrix products in IEEE float32
    on the CPU.  TF32 keeps about three decimal digits and bf16 about two,
    below what the bandit's accept rule and elimination margins
    resolve."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return
    mm = getattr(torch.backends.mkldnn, "matmul", None)
    if getattr(mm, "fp32_precision", "ieee") != "ieee":
        mm.fp32_precision = "ieee"


def register_metric(name: str, fn: Metric) -> None:
    _REGISTRY[name] = fn


def get_metric(name: str) -> Metric:
    if name not in _REGISTRY:
        raise KeyError(f"unknown metric {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_metrics():
    return sorted(_REGISTRY)


def l2sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance via ||x||^2 + ||y||^2 - 2 x.y."""
    full_fp32(x)
    xx = torch.sum(x * x, dim=-1)[:, None]
    yy = torch.sum(y * y, dim=-1)[None, :]
    xy = x @ y.T
    return torch.clamp_min(xx + yy - 2.0 * xy, 0.0)


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(l2sq(x, y))


def cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine *distance* 1 - cos_sim, safe at zero vectors."""
    full_fp32(x)
    xn = x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, -1, keepdim=True),
                                         1e-30))
    yn = y * torch.rsqrt(torch.clamp_min(torch.sum(y * y, -1, keepdim=True),
                                         1e-30))
    return 1.0 - xn @ yn.T


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Manhattan distance, chunked over references to bound memory.  One
    ``[m, chunk, d]`` buffer serves every chunk, the difference written
    into it and its absolute value taken in place: the same sums, bit for
    bit, as ``sum(abs(x - y))`` over fresh temporaries, without two new
    blocks a chunk."""
    m, d = x.shape
    r = y.shape[0]
    chunk = max(1, min(r, _L1_CHUNK_ELEMS // max(1, m * d)))
    out = torch.empty((m, r), dtype=torch.float32, device=x.device)
    buf = torch.empty((m * chunk * d,), dtype=torch.result_type(x, y),
                      device=x.device)
    for lo in range(0, r, chunk):
        yc = y[lo:lo + chunk]
        diff = buf[:m * yc.shape[0] * d].view(m, yc.shape[0], d)
        torch.sub(x[:, None, :], yc[None, :, :], out=diff)
        out[:, lo:lo + chunk] = torch.sum(diff.abs_(), dim=-1)
    return out


# float32 holds integers exactly up to 2**24, which bounds the index
# column.
_MAX_PRECOMPUTED_N = 1 << 24


def attach_index(dissim) -> torch.Tensor:
    """Prepare an ``[n, n]`` dissimilarity matrix (numpy or tensor; a
    tensor keeps its device) for ``metric="precomputed"``: each row's own
    index is appended as a trailing column, so row blocks stay
    self-describing under the solvers' index-only data access."""
    d = torch.as_tensor(dissim, dtype=torch.float32)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f'metric="precomputed" expects a square [n, n] '
                         f"dissimilarity matrix, got shape {tuple(d.shape)}")
    n = d.shape[0]
    if n >= _MAX_PRECOMPUTED_N:
        raise ValueError(f"precomputed index column is exact only for "
                         f"n < {_MAX_PRECOMPUTED_N}, got n={n}")
    idx = torch.arange(n, dtype=torch.float32, device=d.device)[:, None]
    return torch.cat([d, idx], dim=1).contiguous()


def check_index_column(col: torch.Tensor, n_cols: int) -> None:
    """Raise unless ``col`` holds column indices of a ``n_cols``-column
    matrix: integers in ``[0, n_cols)``.  On a CUDA tensor this reads
    from the device, so the solvers call it once, on their data, before
    the fit (:func:`check_data`)."""
    if col.numel() and not bool(torch.all((col >= 0) & (col < n_cols)
                                          & (col == torch.round(col)))):
        raise ValueError(
            'metric="precomputed" data must be routed through '
            "attach_index() (the trailing column must hold row indices); "
            "got non-index values: pass the raw [n, n] matrix to "
            "repro_torch.api.KMedoids, or call attach_index yourself "
            "before the other entry points")


def precomputed(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Lookup 'metric' over ``attach_index``-augmented data: x rows carry
    ``D[i, :]``, the y rows' trailing column carries ``j``, so the block
    is a gather ``D[I, J]``.  A CPU call checks the index column (a raw,
    un-augmented matrix fails at the first distance call, as in the JAX
    package); on the card, where that check would read from the device
    in every round, :func:`check_data` makes it once per fit, and the
    gather's indices are clamped so no input can fault the device."""
    col = y[:, -1]
    n_cols = x.shape[1] - 1
    if not col.is_cuda:
        check_index_column(col, n_cols)
    j = torch.clamp(col.to(torch.int64), 0, max(n_cols - 1, 0))
    return torch.index_select(x[:, :-1], 1, j)


def check_data(data: torch.Tensor, metric: str) -> None:
    """A solver's one check of its data: for ``"precomputed"`` the
    trailing column must index the matrix's columns."""
    if metric == "precomputed":
        check_index_column(data[:, -1], data.shape[1] - 1)


def resolve_metric(metric) -> str:
    """Normalise a user-facing ``metric`` argument to a registered name.

    Accepts a registered name (validated), ``"precomputed"`` (the caller
    routes the data through :func:`attach_index`), or a raw
    ``[m, d] x [r, d] -> [m, r]`` callable, registered under a name
    derived from the function (the same object always resolves to the
    same name; a new one never takes an existing name).
    """
    if isinstance(metric, str):
        get_metric(metric)  # raises KeyError for unknown names
        return metric
    if callable(metric):
        for name, fn in _REGISTRY.items():
            if fn is metric:
                return name
        base = getattr(metric, "__name__", None) or "metric"
        name, i = base, 0
        while name in _REGISTRY:   # never clobber an existing registration
            i += 1
            name = f"{base}_{i}"
        register_metric(name, metric)
        return name
    raise TypeError(f"metric must be a registered name, 'precomputed', or a "
                    f"callable; got {type(metric).__name__}")


register_metric("l2", l2)
register_metric("l2sq", l2sq)
register_metric("l1", l1)
register_metric("cosine", cosine)
register_metric("precomputed", precomputed)


def pairwise(x: torch.Tensor, y: torch.Tensor, *, metric: str = "l2"
             ) -> torch.Tensor:
    """Pairwise dissimilarity ``[m, d] x [r, d] -> [m, r]``."""
    return get_metric(metric)(x, y)
