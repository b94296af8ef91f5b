"""Mixture-of-Experts layer (``repro.models.moe``' counterpart): top-k
routing with sort-based capacity dispatch, Switch semantics.

The JAX layer views the tokens as ``[n_data_shards, T_loc, d]`` and
dispatches within each shard; without a mesh it has one shard, and the
port has no mesh yet (ROADMAP A17f), so this is that layer at one shard:

* float32 router logits ``x @ router``, softmax, the top ``k`` experts a
  token, the gates renormalised by ``max(sum, 1e-9)``;
* the flat expert ids sorted **stably** (assignment ``i`` of token ``t``
  is entry ``t·k + i``), each expert's segment found by
  ``searchsorted``, an assignment's position in its expert ``pos``, kept
  while ``pos < C`` (:func:`capacity`); a dropped assignment's ``slot``
  is the overflow row ``E·C`` of a buffer of ``E·C + 1`` rows;
* each expert's SwiGLU over its ``C`` rows as batched products over E
  (``torch.bmm``; the JAX layer's ``einsum``, outside any kernel);
* the combine: each kept assignment's expert output times its gate,
  added onto its token (``index_add``) in the sorted order;
* the Switch load-balancing loss ``E·Σ_e me_e·ce_e``, ``me`` the mean
  router probability and ``ce`` the share of assignments, dropped ones
  included.

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

from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device

F32 = torch.float32


def capacity(t: int, k: int, e: int, cf: float) -> int:
    """Slots an expert: ``ceil(t·k·cf / e)`` padded to a multiple of 8,
    at least 8 (the JAX function, float arithmetic included)."""
    c = int(-(-t * k * cf // e))
    return max(8, -(-c // 8) * 8)


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
    """A layer's routing of T tokens: ``probs`` [T, E] (float32),
    ``eidx`` / ``gate`` [T, k], and over the T·k assignments in sorted
    order ``order`` (the flat index ``t·k + i``), ``keep`` and ``slot``
    (``E·C`` where dropped); ``c`` is the capacity."""
    probs: torch.Tensor
    eidx: torch.Tensor
    gate: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    c: int


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int,
          capacity_factor: float) -> Dispatch:
    """The routing of tokens ``xt`` [T, d] (module docstring).

    The top k come from a stable descending sort of each token's
    probabilities, so equal probabilities rank the lower expert index
    first, as ``jax.lax.top_k`` ranks them: a tie picks the same experts
    in both packages (``torch.topk`` promises no order among ties)."""
    t = xt.shape[0]
    e = router.shape[1]
    c = capacity(t, top_k, e, capacity_factor)
    probs = torch.softmax(xt.to(F32) @ router, dim=-1)              # [T, E]
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :top_k], eidx[:, :top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_e = eidx.reshape(-1)                                       # [T·k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg = torch.searchsorted(sorted_e, torch.arange(e, device=xt.device))
    pos = torch.arange(t * top_k, device=xt.device) - seg[sorted_e]
    keep = pos < c
    slot = torch.where(keep, sorted_e * c + pos, e * c)
    return Dispatch(probs, eidx, gate, order, keep, slot, c)


def moe_layer(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d] -> (y [B, L, d], aux_loss, a 0-d float32 tensor)."""
    b, l, d = x.shape
    e = p.router.shape[1]
    t = b * l
    xt = x.reshape(t, d)
    r = route(p.router, xt, top_k, capacity_factor)
    c = r.c
    tok = torch.div(r.order, top_k, rounding_mode="floor")
    # Dropped assignments all land on the overflow row, which is cut off:
    # which of them a duplicate index leaves there does not matter.
    buf = x.new_zeros(e * c + 1, d).index_copy(0, r.slot, xt[tok])
    h = buf[:-1].reshape(e, c, d)
    act = F.silu(torch.bmm(h, p.wg)) * torch.bmm(h, p.wi)          # [E, C, ff]
    out = torch.bmm(act, p.wo).reshape(e * c, d)
    gathered = out[torch.clamp_max(r.slot, e * c - 1)] * r.keep[:, None].to(
        x.dtype)
    wsel = r.gate.reshape(-1)[r.order][:, None].to(x.dtype)
    # A token receives at most top_k terms onto zero; with top_k <= 2 the
    # sum is the same in any order (a + b == b + a in floating point), so
    # the card's atomic adds give the bits of the CPU's sequential ones.
    y = x.new_zeros(t, d).index_add(0, tok, gathered * wsel)
    me = r.probs.mean(0)                                            # [E]
    ce = torch.zeros(e, dtype=F32, device=x.device).index_add(
        0, r.eidx.reshape(-1),
        torch.ones(t * top_k, dtype=F32, device=x.device)) / (t * top_k)
    aux = e * torch.sum(me * ce)
    return y.reshape(b, l, d), aux


def dropped(p: MoE, x: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> torch.Tensor:
    """The assignments of ``x`` [B, L, d] that the layer drops at this
    capacity, a 0-d tensor on ``x``'s device (read it outside a timed
    region)."""
    r = route(p.router, x.reshape(-1, x.shape[-1]), top_k, capacity_factor)
    return (~r.keep).sum()
