"""int8 error-feedback gradient compression for the cross-pod reduction
(``repro.distributed.compression``' counterpart).

Only the pod leg of the gradient reduction is compressed: each pod rank
of a ``torch.distributed`` group holds its full-precision gradient
``g``, and

    q, s      = int8 quantize(g + residual)      (one scale a tensor)
    G         = Σ_p s_p · q_p                    (int8 all-gathered: 4x
                                                  fewer bytes than an f32
                                                  ring all-reduce)
    residual' = (g + residual) − s · q           (error feedback)

Error feedback carries the quantization error into the next step
instead of dropping it (Karimireddy et al., 2019).  The arithmetic is
the JAX functions', exactly: the scale is ``max|x| / 127 + 1e-30``, the
rounding half to even (``torch.round`` and ``jnp.round`` both), the
divisions true divisions by device tensors (a CUDA division by a host
scalar multiplies by its reciprocal), and the gathered terms summed in
rank order.  XLA:CPU fuses ``xr - q·s`` into one multiply-add, so the
residual is rounded once here too (:func:`_residual_`).  Only the sum
may differ in its last bit: XLA:CPU's ``tensordot`` adds each term after
the first with a fused multiply-add, and the port rounds the product
first.

The JAX tree stacks a decoder layer's tensor over the layers of its
pattern position, and quantizes each leaf with one scale; the port
holds one tensor a layer.  :func:`tree_psum_int8_ef` therefore takes
``leaves``, the tensors that share a scale
(``models.model.reference_leaves``), and sends each such leaf as one
int8 tensor and one scale.

Each gather is counted by its dtype where it is issued
(:func:`gather_counts`), so a caller can show that the int8 tensors are
what crossed the wire.
"""

from __future__ import annotations

from typing import (Dict, List, Mapping, MutableMapping, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

F32 = torch.float32

# all_gather calls by the gathered tensor's dtype.
_GATHERS: Dict[torch.dtype, int] = {}


def gather_counts() -> Dict[torch.dtype, int]:
    """The all-gathers issued since :func:`reset_gather_counts`, by the
    dtype of the tensor gathered."""
    return dict(_GATHERS)


def reset_gather_counts() -> None:
    _GATHERS.clear()


def _scale(xs) -> torch.Tensor:
    """One scale for the tensors ``xs`` (float32): ``max|x| / 127 +
    1e-30`` over all of them, a 0-d tensor."""
    c127 = torch.full((), 127.0, dtype=F32, device=xs[0].device)
    top = torch.max(torch.stack([torch.max(torch.abs(x)) for x in xs]))
    return top / c127 + 1e-30


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``q`` int8 in [-127, 127], ``scale`` a float32 0-d
    tensor with ``x ≈ q · scale``."""
    x = x.to(F32)
    scale = _scale([x])
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _all_gather(t: torch.Tensor, group) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    _GATHERS[t.dtype] = _GATHERS.get(t.dtype, 0) + 1
    return parts


# Elements a chunk in :func:`_residual_`: its float64 temporaries stay
# near 128 MB however large the tensor.
_CHUNK = 1 << 24


def _residual_(xr: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
               ) -> None:
    """``xr`` (float32, any strides) rewritten in place into ``xr -
    q·scale`` rounded once, as a fused multiply-add gives it; ``q`` holds
    ``xr``'s elements in row-major order.  In float64 the product (7 bits
    times 24) is exact, and so is the difference: where ``q != 0``,
    ``|xr| >= scale / 2``, so both terms are multiples of a quarter of
    ``scale``'s ulp and the difference is at most ``scale / 2``.  The one
    rounding is the copy back to float32.  Rows go ``_CHUNK`` elements at
    a time."""
    s64 = scale.double()
    x2 = xr if xr.dim() else xr.view(1)
    rows = max(1, _CHUNK * x2.shape[0] // max(x2.numel(), 1))
    for xc, qc in zip(x2.split(rows), q.view(x2.shape).split(rows)):
        xc.copy_(xc.double() - qc.double() * s64)


def _psum_leaf(xrs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The compressed sums over the ranks of ``group`` of one leaf: the
    float32 tensors ``xrs`` (each a value plus its residual) quantized
    with one scale, sent as one int8 tensor and the scale.  Each of
    ``xrs`` is rewritten in place into its new residual, ``xr - s·q``
    (:func:`_residual_`)."""
    scale = _scale(xrs)
    sizes = [x.numel() for x in xrs]
    q = torch.empty(sum(sizes), dtype=torch.int8, device=xrs[0].device)
    for xr, qi in zip(xrs, torch.split(q, sizes)):
        qi.copy_(_quantize(xr, scale).reshape(-1))
        _residual_(xr, qi, scale)
    qg = [qp.split(sizes) for qp in _all_gather(q, group)]  # int8 on the wire
    sg = _all_gather(scale.reshape(1), group)    # one float32 a rank
    totals = []
    for i, xr in enumerate(xrs):
        total = sg[0][0] * qg[0][i].view(xr.shape).to(F32)
        for s, qp in zip(sg[1:], qg[1:]):
            total.add_(s[0] * qp[i].view(xr.shape).to(F32))
        totals.append(total)
    return totals


def psum_int8_ef(x: torch.Tensor, residual: torch.Tensor,
                 group: Optional[dist.ProcessGroup] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed sum of ``x`` over the ranks of ``group`` (the WORLD
    group when None) with error feedback: returns ``(total ≈ Σ_p x_p,
    new_residual)``.  Every rank of the group calls it with its own
    ``x`` and ``residual``; every rank gets the same ``total``."""
    xr = x.to(F32) + residual
    total, = _psum_leaf([xr], group)
    return total, xr


def tree_psum_int8_ef(tree: MutableMapping[str, torch.Tensor],
                      residuals: Mapping[str, torch.Tensor],
                      group: Optional[dist.ProcessGroup] = None,
                      leaves: Optional[Sequence[Sequence[str]]] = None
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Mapping[str, torch.Tensor]]:
    """:func:`psum_int8_ef` over the tensors of ``tree`` (e.g. the
    gradients keyed as ``models.model.params_of``) and their residuals
    of the same keys: returns ``(sums, residuals)``.  ``leaves`` groups
    the keys by the scale they share (each key alone when None).

    It holds one copy of the tensors' size at a time beside the
    residuals: each tensor is popped from ``tree`` as it is added into
    its residual, and the residuals are rewritten in place into the new
    ones (float32, as :func:`init_residuals` makes them), so ``tree`` is
    empty on return and ``residuals`` is the mapping given."""
    if leaves is None:
        leaves = [(name,) for name in tree]
    names = [name for leaf in leaves for name in leaf]
    if (sorted(names) != sorted(tree)
            or tree.keys() != residuals.keys()):
        raise ValueError("the leaves, tensors and residuals are not keyed "
                         "alike")
    sums = {}
    for leaf in leaves:
        for name in leaf:
            residuals[name].add_(tree.pop(name).to(F32))
        sums.update(zip(leaf, _psum_leaf([residuals[n] for n in leaf],
                                         group)))
    return sums, residuals


def init_residuals(tree: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Zero float32 residuals shaped as ``tree``'s tensors."""
    return {name: torch.zeros(p.shape, dtype=F32, device=p.device)
            for name, p in tree.items()}
