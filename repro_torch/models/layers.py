"""Transformer building blocks (``repro.models.layers``' counterpart):
RMSNorm, RoPE, GQA attention (global / sliding-window "local" /
llama4-style "chunked"), the attention projections with qk-norm and the
SwiGLU MLP.

Each function computes what the JAX function of its name computes, in
the same float32 steps: attention is the chunked online-softmax form
(an outer loop over query chunks, for each only the kv chunks its mask
can reach, scores in float32 scaled by ``hd ** -0.5``, masked with
``-1e30``), written with plain tensor ops as the JAX package writes it
with plain ``jnp`` (no library attention, which would pick its own
backend and precision on the card).  The weights live in modules
(:class:`Attention`, :class:`MLP`, :class:`RMSNorm`); a JAX ``x @ w``
weight ``[in, out]`` is an ``nn.Linear`` weight ``[out, in]``, its
transpose.

``decode_attention`` is the single-token path against a (possibly
rolling) KV cache, masked by the cache entries' absolute positions.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from ..distributed.sharding import like, per_shard, shard, splittable

F32 = torch.float32
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.to(F32)
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (n * w.to(F32)).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., L, H, Dh]; pos: [L] absolute positions.  The angles in
    float32, as the JAX function makes them."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = pos.to(F32)[:, None] * freqs[None, :]            # [L, half]
    cos = like(torch.cos(ang)[None, :, None, :], x)
    sin = like(torch.sin(ang)[None, :, None, :], x)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _mask(kind: str, window: int, qpos: torch.Tensor, kpos: torch.Tensor
          ) -> torch.Tensor:
    """[Cq, Ck] boolean admissibility mask for absolute positions."""
    q = qpos[:, None]
    k = kpos[None, :]
    m = k <= q                                    # causal
    if kind == "local":
        m &= k > q - window
    elif kind == "chunked":
        m &= torch.div(k, window, rounding_mode="floor") == torch.div(
            q, window, rounding_mode="floor")
    return m


def _kv_range(kind: str, window: int, qo: int, cq: int, ck: int, lk: int
              ) -> Tuple[int, int]:
    """Static kv-chunk index range [j0, j1) reachable from q chunk at qo."""
    hi = min(lk, qo + cq)                         # causal upper bound
    if kind == "global":
        lo = 0
    elif kind == "local":
        lo = max(0, qo - window + 1)
    elif kind == "chunked":
        lo = (qo // window) * window
    else:
        raise ValueError(kind)
    return lo // ck, -(-hi // ck)


def _sdpa_chunk(q, k, v, m, l, acc, mask):
    """One online-softmax accumulation step.

    q: [B, H, Cq, Dh]; k, v: [B, H, Ck, Dh]; mask: [Cq, Ck];
    m, l: [B, H, Cq]; acc: [B, H, Cq, Dh] (f32).
    """
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.to(F32), k.to(F32).transpose(-1, -2)) * scale
    s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, -1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + torch.sum(p, -1)
    acc_new = acc * alpha[..., None] + torch.matmul(
        p.to(v.dtype).to(F32), v.to(F32))
    return m_new, l_new, acc_new


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kind: str, window: int, q_chunk: int = 2048,
              kv_chunk: int = 2048) -> torch.Tensor:
    """Self-attention for prefill/train (Lq == Lk, q offset 0).

    q: [B, L, H, Dh]; k, v: [B, L, KVH, Dh] -> [B, L, H, Dh].  On a mesh
    each rank attends over its own batch rows and heads (``per_shard``;
    the keys and values placed as the queries are): no collective, and
    each score and sum in the one-process order.
    """
    b, lq, h, dh = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if g > 1:
        # ``jnp.repeat(k, g, axis=2)``: each kv head g times in a row
        # (repeat_interleave's order), as a view whose gradient is a sum.
        k = k[:, :, :, None].expand(b, lk, kvh, g, dh).reshape(b, lk, h, dh)
        v = v[:, :, :, None].expand(b, lk, kvh, g, dh).reshape(b, lk, h, dh)
    return per_shard(functools.partial(
        _attention, kind=kind, window=window, q_chunk=q_chunk,
        kv_chunk=kv_chunk), 1, q, q, k, v)[0]


def _attention(q, k, v, *, kind, window, q_chunk, kv_chunk):
    """:func:`attention` on plain tensors, k and v with H heads; a
    1-tuple."""
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    qh = q.movedim(2, 1)                    # [B, H, L, Dh]
    kh = k.movedim(2, 1)
    vh = v.movedim(2, 1)

    cq = min(q_chunk, lq)
    ck = min(kv_chunk, lk)
    assert lq % cq == 0 and lk % ck == 0, (lq, cq, lk, ck)

    outs = []
    for qi in range(lq // cq):
        qo = qi * cq
        qblk = qh[:, :, qo:qo + cq]
        j0, j1 = _kv_range(kind, window, qo, cq, ck, lk)
        qpos = qo + torch.arange(cq, device=q.device)
        m = torch.full((b, h, cq), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((b, h, cq), dtype=F32, device=q.device)
        acc = torch.zeros((b, h, cq, dh), dtype=F32, device=q.device)
        for j in range(j0, j1):
            kc = kh[:, :, j * ck:(j + 1) * ck]
            vc = vh[:, :, j * ck:(j + 1) * ck]
            kpos = j * ck + torch.arange(ck, device=q.device)
            msk = _mask(kind, window, qpos, kpos)
            m, l, acc = _sdpa_chunk(qblk, kc, vc, m, l, acc, msk)
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.cat(outs, dim=2)                          # [B, H, L, Dh]
    return (out.movedim(1, 2).to(q.dtype),)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, entry_pos: torch.Tensor,
                     pos: torch.Tensor, *, kind: str, window: int
                     ) -> torch.Tensor:
    """Single-token attention against a cache.

    q: [B, 1, H, Dh]; caches: [B, S_cache, KVH, Dh]; entry_pos: [B or 1,
    S_cache] absolute positions of the cache entries (negative: empty);
    pos: 0-d tensor, the query token's absolute position.  Scores in
    float32; ``local`` admits the last ``window`` positions, ``chunked``
    the positions of the query's ``pos // window`` chunk.
    """
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q[:, 0].reshape(b, kvh, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(F32),
                     k_cache.to(F32)) * dh ** -0.5
    valid = (entry_pos >= 0) & (entry_pos <= pos)
    if kind == "local":
        valid &= entry_pos > pos - window
    elif kind == "chunked":
        valid &= torch.div(entry_pos, window, rounding_mode="floor") == (
            torch.div(pos, window, rounding_mode="floor"))
    s = torch.where(like(valid[:, None, None, :], s), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return o.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Modules: the weights, initialised from an explicit generator
# ---------------------------------------------------------------------------

def _linear(d_in: int, d_out: int, std: float, generator, device, dtype
            ) -> nn.Linear:
    """``nn.Linear(d_in, d_out, bias=False)`` with N(0, std²) weights drawn
    from ``generator`` (the JAX ``normal(key, (d_in, d_out)) * std``)."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False,
                             device=device, dtype=dtype)
    with torch.no_grad():
        lin.weight.normal_(0.0, std, generator=generator)
    return lin


class RMSNorm(nn.Module):
    def __init__(self, d: int, device: DeviceLike = None, dtype=F32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=resolve_device(device),
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


class Attention(nn.Module):
    """The JAX ``init_attn`` tree: ``wq``, ``wk``, ``wv``, ``wo`` and, with
    qk-norm, ``q_norm`` / ``k_norm``."""

    def __init__(self, d_in: int, n_heads: int, n_kv: int, hd: int,
                 d_out: int, qk_norm: bool, generator=None,
                 device: DeviceLike = None, dtype=F32):
        super().__init__()
        device = resolve_device(device)
        s = d_in ** -0.5
        self.wq = _linear(d_in, n_heads * hd, s, generator, device, dtype)
        self.wk = _linear(d_in, n_kv * hd, s, generator, device, dtype)
        self.wv = _linear(d_in, n_kv * hd, s, generator, device, dtype)
        self.wo = _linear(n_heads * hd, d_out, (n_heads * hd) ** -0.5,
                          generator, device, dtype)
        self.q_norm: Optional[RMSNorm] = None
        self.k_norm: Optional[RMSNorm] = None
        if qk_norm:
            self.q_norm = RMSNorm(hd, device, dtype)
            self.k_norm = RMSNorm(hd, device, dtype)


def attn_qkv(p: Attention, x: torch.Tensor, pos: torch.Tensor, *,
             n_heads: int, n_kv: int, hd: int, theta: float, qk_norm: bool):
    b, l, _ = x.shape
    q = splittable(p.wq(x), -1, n_heads).reshape(b, l, n_heads, hd)
    k = p.wk(x).reshape(b, l, n_kv, hd)
    v = p.wv(x).reshape(b, l, n_kv, hd)
    if qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    q = rope(q, pos, theta)
    k = rope(k, pos, theta)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


class MLP(nn.Module):
    """The JAX ``init_mlp`` tree: ``wi``, ``wg``, ``wo`` (SwiGLU)."""

    def __init__(self, d: int, ff: int, generator=None,
                 device: DeviceLike = None, dtype=F32):
        super().__init__()
        device = resolve_device(device)
        self.wi = _linear(d, ff, d ** -0.5, generator, device, dtype)
        self.wg = _linear(d, ff, d ** -0.5, generator, device, dtype)
        self.wo = _linear(ff, d, ff ** -0.5, generator, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(p.wg(x)) * p.wi(x)
    h = shard(h, "batch", "seq", "ff")
    return p.wo(h)
