"""Mixture-of-Experts layer (``repro.models.moe``' counterpart): top-k
routing with sort-based capacity dispatch, Switch semantics.

The tokens are viewed as ``[ns, T_loc, d]``, ``ns`` the extent of the
mesh's ``pod`` × ``data`` axes (``distributed.sharding.get_mesh``; 1
without a mesh, and 1 where ``T`` is not a multiple of it), and each
shard dispatches its own ``T_loc`` tokens at the capacity of ``T_loc``
tokens, as the JAX layer does:

* float32 router logits ``x @ router``, softmax, the top ``k`` experts a
  token, the gates renormalised by ``max(sum, 1e-9)``;
* the flat expert ids sorted **stably** (assignment ``i`` of token ``t``
  is entry ``t·k + i``), each expert's segment found by
  ``searchsorted``, an assignment's position in its expert ``pos``, kept
  while ``pos < C`` (:func:`capacity`); a dropped assignment's ``slot``
  is the overflow row ``E·C`` of a buffer of ``E·C + 1`` rows;
* each expert's SwiGLU over its ``ns·C`` rows as batched products over
  E (the JAX layer's ``einsum``, outside any kernel);
* the combine: each kept assignment's expert output times its gate,
  added onto its token (``index_add``) in the sorted order;
* the Switch load-balancing loss ``E·Σ_e me_e·ce_e``, ``me`` the mean
  router probability and ``ce`` the share of assignments, dropped ones
  included.

On a mesh the dispatch and the combine run on each rank's own shards
(``sharding.per_shard``, the JAX ``vmap`` inside a shard-local
constraint), the
dispatch buffer is resharded from the data axes to the expert axis
(``model``) for the expert FFN and back (the MoE all-to-all), and the
expert weights stay sharded over their leading axis.

Every shape is fixed by ``(T, k, E, C)``: no ``nonzero``, no boolean
indexing and no read back to the host, so a decode step runs ahead of
the host on the card.  The dispatch is a pure function of the inputs,
so a checkpointed group recomputes it exactly.

The weights keep the JAX layouts (``router [d, E]`` in float32, ``wi`` /
``wg [E, d, ff]``, ``wo [E, ff, d]``): they are batched-product
operands, not ``nn.Linear`` weights, and cross from the JAX package
untransposed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from ..distributed.sharding import get_mesh, like, per_shard, shard

F32 = torch.float32


def capacity(t: int, k: int, e: int, cf: float) -> int:
    """Slots an expert: ``ceil(t·k·cf / e)`` padded to a multiple of 8,
    at least 8 (the JAX function, float arithmetic included)."""
    c = int(-(-t * k * cf // e))
    return max(8, -(-c // 8) * 8)


def n_data_shards(t: int) -> int:
    """The dispatch's shard count for ``t`` tokens: the mesh's ``pod`` ×
    ``data`` extent, or 1 without a mesh or where it does not divide
    ``t`` (the JAX fallback for tiny inputs on a big mesh)."""
    mesh = get_mesh()
    ns = 1
    if mesh is not None:
        for a in ("pod", "data"):
            if a in mesh.mesh_dim_names:
                ns *= mesh.size(mesh.mesh_dim_names.index(a))
    return 1 if t % ns else ns


def _param(shape, std: float, generator, device, dtype) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class MoE(nn.Module):
    """The JAX ``init_moe`` tree: ``router`` [d, E] (always float32),
    ``wi``, ``wg`` [E, d, ff] and ``wo`` [E, ff, d], with its standard
    deviations ``d**-0.5`` and ``ff**-0.5``."""

    def __init__(self, d: int, ff: int, n_experts: int, generator=None,
                 device: DeviceLike = None, dtype=F32):
        super().__init__()
        device = resolve_device(device)
        s = d ** -0.5
        self.router = _param((d, n_experts), s, generator, device, F32)
        self.wi = _param((n_experts, d, ff), s, generator, device, dtype)
        self.wg = _param((n_experts, d, ff), s, generator, device, dtype)
        self.wo = _param((n_experts, ff, d), ff ** -0.5, generator, device,
                         dtype)


class Dispatch(NamedTuple):
    """A layer's routing of T tokens in ``ns`` shards: ``probs`` [T, E]
    (float32), ``eidx`` / ``gate`` [T, k], and over the T·k assignments,
    shard after shard, each shard's in its sorted order, ``order`` (the
    flat index ``t·k + i``, ``t`` the global token), ``keep`` and
    ``slot`` (the shard's buffer row, ``E·C`` where dropped); ``c`` is
    the capacity of a shard."""
    probs: torch.Tensor
    eidx: torch.Tensor
    gate: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    c: int


def _gates(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """``(probs [T, E], gate [T, k], eidx [T, k])``.  The top k come from
    a stable descending sort of each token's probabilities, so equal
    probabilities rank the lower expert index first, as ``jax.lax.top_k``
    ranks them: a tie picks the same experts in both packages
    (``torch.topk`` promises no order among ties)."""
    probs = torch.softmax(xt.to(F32) @ router, dim=-1)              # [T, E]
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :top_k], eidx[:, :top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, eidx


def _plan(eidx: torch.Tensor, e: int, c: int):
    """One shard's dispatch of its assignments ``eidx`` [T_loc, k]:
    ``(order, keep, slot)`` over its T_loc·k assignments in sorted
    order."""
    flat_e = eidx.reshape(-1)                                       # [T·k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg = torch.searchsorted(sorted_e, torch.arange(e, device=eidx.device))
    pos = torch.arange(flat_e.shape[0], device=eidx.device) - seg[sorted_e]
    keep = pos < c
    slot = torch.where(keep, sorted_e * c + pos, e * c)
    return order, keep, slot


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int,
          capacity_factor: float, ns: int = 1) -> Dispatch:
    """The routing of tokens ``xt`` [T, d] in ``ns`` shards of ``T/ns``
    tokens (module docstring)."""
    t = xt.shape[0]
    e = router.shape[1]
    t_loc = t // ns
    c = capacity(t_loc, top_k, e, capacity_factor)
    probs, gate, eidx = _gates(router, xt, top_k)
    plans = [_plan(eidx[s * t_loc:(s + 1) * t_loc], e, c) for s in range(ns)]
    order = torch.cat([o + s * t_loc * top_k
                       for s, (o, _, _) in enumerate(plans)])
    keep = torch.cat([k for _, k, _ in plans])
    slot = torch.cat([sl for _, _, sl in plans])
    return Dispatch(probs, eidx, gate, order, keep, slot, c)


def _local_dispatch(xt_s, eidx_s, *, top_k: int, e: int, c: int):
    """The dispatch of each shard of ``xt_s`` [n, T_loc, d] (its
    assignments ``eidx_s`` [n, T_loc, k]): the buffers [n, E, C, d] and
    each shard's ``(order, keep, slot)``."""
    d = xt_s.shape[-1]
    out = []
    for xt, eidx in zip(xt_s, eidx_s):
        order, keep, slot = _plan(eidx, e, c)
        tok = torch.div(order, top_k, rounding_mode="floor")
        # Dropped assignments all land on the overflow row, which is cut
        # off: which of them a duplicate index leaves there does not
        # matter.
        buf = xt.new_zeros(e * c + 1, d).index_copy(0, slot, xt[tok])
        out.append((buf[:-1].reshape(e, c, d), order, keep, slot))
    return tuple(torch.stack(a) for a in zip(*out))


def _local_combine(out_s, order_s, keep_s, slot_s, gate_s, *, top_k: int):
    """Each shard's combine: its expert outputs ``out_s`` [n, E, C, d]
    times the gates, added onto its tokens in sorted order; ``(y,)``, y
    [n, T_loc, d]."""
    n, e, c, d = out_s.shape
    ys = []
    for out, order, keep, slot, gate in zip(out_s, order_s, keep_s, slot_s,
                                            gate_s):
        flat = out.reshape(e * c, d)
        gathered = flat[torch.clamp_max(slot, e * c - 1)] * keep[
            :, None].to(out.dtype)
        wsel = gate.reshape(-1)[order][:, None].to(out.dtype)
        tok = torch.div(order, top_k, rounding_mode="floor")
        # A token receives at most top_k terms onto zero; with top_k <= 2
        # the sum is the same in any order (a + b == b + a in floating
        # point), so the card's atomic adds give the bits of the CPU's
        # sequential ones.
        ys.append(out.new_zeros(gate.shape[0], d).index_add(
            0, tok, gathered * wsel))
    return (torch.stack(ys),)


def moe_layer(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d] -> (y [B, L, d], aux_loss, a 0-d float32 tensor)."""
    b, l, d = x.shape
    e = p.router.shape[1]
    t = b * l
    ns = n_data_shards(t)
    t_loc = t // ns
    c = capacity(t_loc, top_k, e, capacity_factor)
    xt = x.reshape(t, d)
    probs, gate, eidx = _gates(p.router, xt, top_k)
    # The shard axis goes over the data axes; in the one-shard fallback
    # it stays whole (an axis of one does not split over the data ranks).
    bat = "batch" if ns > 1 else None

    # ---- per-shard sort-based dispatch (shard-local by construction) ----
    xt_s = shard(xt.reshape(ns, t_loc, d), bat, None, None)
    eidx_s = eidx.reshape(ns, t_loc, top_k)
    bufs, orders, keeps, slots = per_shard(
        functools.partial(_local_dispatch, top_k=top_k, e=e, c=c), 4, xt_s,
        xt_s, eidx_s)

    # ---- expert FFN: the E-axis reshard below is the MoE all-to-all ----
    h = bufs.movedim(1, 0)                                  # [E, ns, C, d]
    h = shard(h, "experts", bat, None, None)
    act = F.silu(torch.einsum("encd,edf->encf", h, p.wg)) * torch.einsum(
        "encd,edf->encf", h, p.wi)
    act = shard(act, "experts", bat, None, None)
    out = torch.einsum("encf,efd->encd", act, p.wo)
    # Keep the combine product expert-sharded (the weights stay where
    # they are) and only then reshard the small output back.
    out = shard(out, "experts", bat, None, None)
    out = shard(out, None, bat, None, None)                 # a2a back
    out = out.movedim(0, 1)                                 # [ns, E, C, d]

    # ---- per-shard combine ----
    y, = per_shard(functools.partial(_local_combine, top_k=top_k), 1, xt_s,
                   out, orders, keeps, slots, gate.reshape(ns, t_loc, top_k))
    y = shard(y, bat, None, None).reshape(t, d)

    # ---- load-balancing aux loss (Switch) ----
    me = probs.mean(0)                                              # [E]
    # Each expert's count of assignments (exact in float32).
    experts = like(torch.arange(e, device=eidx.device), eidx)
    ce = (eidx[..., None] == experts).to(F32).sum((0, 1)) / (t * top_k)
    aux = e * torch.sum(me * ce)
    return y.reshape(b, l, d), aux


def dropped(p: MoE, x: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> torch.Tensor:
    """The assignments of ``x`` [B, L, d] that the layer drops at this
    capacity (in the mesh's shards), a 0-d tensor on ``x``'s device
    (read it outside a timed region)."""
    xt = x.reshape(-1, x.shape[-1])
    r = route(p.router, xt, top_k, capacity_factor,
              n_data_shards(xt.shape[0]))
    return (~r.keep).sum()
