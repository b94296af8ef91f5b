"""State-space blocks (``repro.models.ssm``' counterpart): Mamba-1
(falcon-mamba) and Mamba-2 (zamba2), full-sequence, prefill and one-token
decode.

* Mamba-1's recurrence ``h_t = dA_t·h_{t-1} + dBx_t`` runs as a
  log-depth scan over the sequence (:func:`_linear_scan`): the JAX block's
  ``jax.lax.associative_scan``, which PyTorch lacks, as a doubling scan
  of ``ceil(log2 L)`` passes over ``[B, L, di, st]`` in plain tensor ops.
  Its additions are grouped differently from XLA's scan, so the two agree
  to float32 rounding, not in every bit.
* Mamba-2 is the SSD chunked form (:func:`_ssd_chunked`): masked decay
  products inside each chunk of ``T`` positions and a scan over the
  ``L/T`` chunk states, a loop over chunks here as ``lax.scan`` is there.

Decode is the O(1) recurrent step on ``(conv_state, ssm_state)``: the
conv state holds the last ``K − 1`` inputs of the causal convolution
(before it), the SSM state ``h`` is float32.  A prompt shorter than
``K − 1`` leaves the JAX prefill a shorter conv tail, which its decode
cannot take; the port pads it on the left with the zeros the causal
convolution saw there, so that its tail always has ``K − 1`` rows.

The JAX ``_mamba1_inner`` options ``h0`` and ``scan_dtype`` are passed by
no caller; the port runs the scan in float32, that function's default.
Projections are ``nn.Linear`` weights (the JAX ``[in, out]`` transposed);
``conv_w`` [K, C] and the vectors keep the JAX layouts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from ..distributed.sharding import like, shard
from .layers import _linear

F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``logaddexp(x, 0)``,
    with no linear cut-off (``F.softplus`` switches to ``x`` past 20)."""
    return torch.logaddexp(x, like(torch.zeros((), dtype=x.dtype,
                                               device=x.device), x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d; x [B, L, C], w [K, C], b [C]."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + l, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """A copy (``F.pad`` makes one, zero rows or not) of the last
    ``k − 1`` rows of x [B, L, C], zero rows first where L < k − 1
    (module docstring): a prefill's state does not hold on to x."""
    tail = x[:, max(0, x.shape[1] - (k - 1)):, :]
    return F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

class Mamba1(nn.Module):
    """The JAX ``init_mamba1`` tree: ``in_x``, ``in_z`` [d → di],
    ``conv_w`` [K, di] (std 0.2), ``conv_b`` 0, ``x_proj`` [di → dtr +
    2·st], ``dt_proj`` [dtr → di], ``dt_bias`` −2 (softplus ≈ 0.12),
    ``A_log = log(1..st)`` for every channel and ``D`` 1 (both float32),
    ``out_proj`` [di → d]."""

    def __init__(self, cfg, generator=None, device: DeviceLike = None,
                 dtype=F32):
        super().__init__()
        device = resolve_device(device)
        d, di, st, dtr, k = (cfg.d_model, cfg.di, cfg.ssm_state, cfg.dtr,
                             cfg.ssm_conv)
        s = d ** -0.5
        self.in_x = _linear(d, di, s, generator, device, dtype)
        self.in_z = _linear(d, di, s, generator, device, dtype)
        conv = torch.empty((k, di), device=device, dtype=dtype)
        self.conv_w = nn.Parameter(conv.normal_(0.0, 0.2,
                                                generator=generator))
        self.conv_b = nn.Parameter(torch.zeros(di, device=device,
                                               dtype=dtype))
        self.x_proj = _linear(di, dtr + 2 * st, di ** -0.5, generator, device,
                              dtype)
        self.dt_proj = _linear(dtr, di, dtr ** -0.5, generator, device, dtype)
        self.dt_bias = nn.Parameter(torch.full((di,), -2.0, device=device,
                                         dtype=dtype))
        a = torch.arange(1, st + 1, dtype=F32, device=device)
        self.A_log = nn.Parameter(torch.log(a[None, :].repeat(di, 1)))
        self.D = nn.Parameter(torch.ones(di, device=device, dtype=F32))
        self.out_proj = _linear(di, d, di ** -0.5, generator, device, dtype)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All ``h_t = a_t·h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``.

    Pass ``s`` (1, 2, 4, ...) folds each position with the one ``s``
    before it, ``(a, b) ∘ (a', b') = (a·a', a'·b + b')``, so after the
    pass position t holds the fold of the ``2s`` positions ending at t
    (or of all of them from 0): ``ceil(log2 L)`` passes."""
    l = a.shape[1]
    s = 1
    while s < l:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                               b[:, :-s])], dim=1)
        if 2 * s < l:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _mamba1_inner(p: Mamba1, xc, dt, Bm, Cm):
    """The selective scan.  xc [B,L,di] (after conv and silu), dt
    [B,L,di], Bm / Cm [B,L,st], all float32.  Returns (y [B,L,di],
    h_last [B,di,st])."""
    A = -torch.exp(p.A_log.to(F32))                              # [di, st]
    dA = torch.exp(dt[..., None] * A[None, None])                # [B,L,di,st]
    dBx = (dt * xc)[..., None] * Bm[:, :, None, :]               # [B,L,di,st]
    h = _linear_scan(dA, dBx)
    y = torch.einsum("blds,bls->bld", h, Cm)
    # A copy: the view would keep the whole [B, L, di, st] scan alive
    # in a prefill's state, one such buffer a layer.
    return y, h[:, -1].clone()


def _mamba1_fwd(p: Mamba1, x: torch.Tensor):
    xin, z = p.in_x(x), p.in_z(x)
    xin = shard(xin, "batch", "seq", "d_inner")
    xc = F.silu(_causal_conv(xin, p.conv_w, p.conv_b))
    proj = p.x_proj(xc)
    dtr = p.dt_proj.weight.shape[1]
    st = (proj.shape[-1] - dtr) // 2
    dt_in, Bm, Cm = torch.split(proj, [dtr, st, st], dim=-1)
    dt = softplus(p.dt_proj(dt_in).to(F32) + p.dt_bias.to(F32))
    y, h_last = _mamba1_inner(p, xc.to(F32), dt, Bm.to(F32), Cm.to(F32))
    y = y + p.D[None, None] * xc.to(F32)
    y = y.to(x.dtype) * F.silu(z)
    k = p.conv_w.shape[0]
    return p.out_proj(y), (_conv_tail(xin, k), h_last)


def mamba1(p: Mamba1, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-1 block (train / prefill). x: [B, L, d]."""
    return _mamba1_fwd(p, x)[0]


def mamba1_prefill(p: Mamba1, x: torch.Tensor):
    """The full-sequence block and its decode state ``(conv [B, K-1, di],
    h [B, di, st])``."""
    return _mamba1_fwd(p, x)


def mamba1_decode(p: Mamba1, x: torch.Tensor,
                  state: Tuple[torch.Tensor, torch.Tensor],
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One-token step.  x: [B, 1, d]; state = (conv [B, K-1, di], h [B,
    di, st]), left as it was; the new state goes into ``out``'s two
    tensors where given."""
    conv_st, h = state
    xin, z = p.in_x(x), p.in_z(x)
    window = torch.cat([conv_st, xin], dim=1)                     # [B, K, di]
    xc = torch.einsum("bkc,kc->bc", window.to(F32), p.conv_w.to(F32)) \
        + p.conv_b.to(F32)
    xc = F.silu(xc)[:, None, :]                                   # [B, 1, di]
    proj = p.x_proj(xc.to(x.dtype))
    dtr = p.dt_proj.weight.shape[1]
    st = (proj.shape[-1] - dtr) // 2
    dt_in, Bm, Cm = torch.split(proj, [dtr, st, st], dim=-1)
    dt = softplus(p.dt_proj(dt_in).to(F32) + p.dt_bias.to(F32))[:, 0]
    A = -torch.exp(p.A_log.to(F32))
    dA = torch.exp(dt[..., None] * A[None])                       # [B, di, st]
    u = (dt * xc[:, 0])[..., None] * Bm.to(F32)[:, 0, None, :]
    h_new = torch.mul(dA, h, out=None if out is None else out[1])
    h_new += u
    y = torch.einsum("bds,bs->bd", h_new, Cm.to(F32)[:, 0])
    y = y + p.D[None] * xc[:, 0]
    y = y[:, None].to(x.dtype) * F.silu(z)
    conv_new = window[:, 1:]
    if out is not None:
        conv_new = out[0].copy_(conv_new)
    return p.out_proj(y), (conv_new, h_new)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD chunked)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """The JAX ``init_mamba2`` tree: ``in_z`` [d → di], ``in_xbc`` [d →
    di + 2·st], ``in_dt`` [d → nh], ``conv_w`` [K, di + 2·st] (std 0.2),
    ``conv_b`` 0, ``dt_bias`` −2, ``A_log`` 0 and ``D`` 1 (float32, one
    a head), ``norm_w`` 1, ``out_proj`` [di → d]."""

    def __init__(self, cfg, generator=None, device: DeviceLike = None,
                 dtype=F32):
        super().__init__()
        device = resolve_device(device)
        d, di, st, k = cfg.d_model, cfg.di, cfg.ssm_state, cfg.ssm_conv
        nh = di // cfg.ssm_head_dim
        s = d ** -0.5
        conv_dim = di + 2 * st
        self.in_z = _linear(d, di, s, generator, device, dtype)
        self.in_xbc = _linear(d, conv_dim, s, generator, device, dtype)
        self.in_dt = _linear(d, nh, s, generator, device, dtype)
        conv = torch.empty((k, conv_dim), device=device, dtype=dtype)
        self.conv_w = nn.Parameter(conv.normal_(0.0, 0.2,
                                                generator=generator))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=device,
                                         dtype=dtype))
        self.dt_bias = nn.Parameter(torch.full((nh,), -2.0, device=device,
                                         dtype=F32))
        self.A_log = nn.Parameter(torch.zeros(nh, device=device, dtype=F32))
        self.D = nn.Parameter(torch.ones(nh, device=device, dtype=F32))
        self.norm_w = nn.Parameter(torch.ones(di, device=device, dtype=dtype))
        self.out_proj = _linear(di, d, di ** -0.5, generator, device, dtype)


def _ssd_chunked(xh, Bm, Cm, loga, chunk: int):
    """SSD: xh [B,L,nh,hd], Bm / Cm [B,L,st], loga [B,L,nh] (log decay
    ≤ 0), float32.  Returns (y [B,L,nh,hd], h_final [B,nh,hd,st]).
    Chunks of ``min(chunk, L)`` positions, which must divide L."""
    b, l, nh, hd = xh.shape
    st = Bm.shape[-1]
    t = min(chunk, l)
    if l % t:
        raise ValueError(f"the sequence length {l} is not a multiple of the "
                         f"SSD chunk {t}")
    nc = l // t
    xh_ = xh.reshape(b, nc, t, nh, hd)
    B_ = Bm.reshape(b, nc, t, st)
    C_ = Cm.reshape(b, nc, t, st)
    lcum = torch.cumsum(loga.reshape(b, nc, t, nh), dim=2)       # [b,nc,t,nh]
    # intra-chunk: scores[i, j] = exp(lcum_i − lcum_j)·(C_i · B_j), j <= i
    g = torch.einsum("bcis,bcjs->bcij", C_, B_)                  # [b,nc,t,t]
    decay = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]   # [b,nc,i,j,nh]
    ar = torch.arange(t, device=xh.device)
    mask = like((ar[:, None] >= ar[None, :])[None, None, :, :, None], xh)
    w = torch.where(mask, torch.exp(decay), 0.0) * g[..., None]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", w, xh_)
    # chunk states: S_c = Σ_j exp(lcum_T − lcum_j)·B_j ⊗ x_j
    ldec = lcum[:, :, -1:, :] - lcum                             # [b,nc,t,nh]
    xw = xh_ * torch.exp(ldec)[..., None]
    S = torch.einsum("bcjs,bcjhd->bchds", B_, xw)        # [b,nc,nh,hd,st]
    # inter-chunk scan: the state entering chunk c
    total = torch.exp(lcum[:, :, -1, :])                         # [b,nc,nh]
    carry = like(torch.zeros((b, nh, hd, st), dtype=F32, device=xh.device),
                 xh)
    s_in = []
    for c in range(nc):
        s_in.append(carry)
        carry = total[:, c, :, None, None] * carry + S[:, c]
    S_in = torch.stack(s_in, dim=1)                      # [b,nc,nh,hd,st]
    y_inter = torch.einsum("bcis,bchds->bcihd", C_, S_in) \
        * torch.exp(lcum)[..., None]
    return (y_intra + y_inter).reshape(b, l, nh, hd), carry


def rms_norm_gated(y, z, w, eps: float = 1e-6):
    y32 = y.to(F32) * F.silu(z.to(F32))
    n = y32 * torch.rsqrt(torch.mean(y32 * y32, -1, keepdim=True) + eps)
    return (n * w.to(F32)).to(y.dtype)


def _heads(p: Mamba2):
    di = p.out_proj.weight.shape[1]
    nh = p.A_log.shape[0]
    st = (p.in_xbc.weight.shape[0] - di) // 2
    return di, nh, di // nh, st


def _mamba2_fwd(p: Mamba2, x: torch.Tensor, chunk: int):
    b, l, _ = x.shape
    di, nh, hd, st = _heads(p)
    z = p.in_z(x)
    xbc = p.in_xbc(x)
    dt_in = p.in_dt(x)
    xbc = shard(xbc, "batch", "seq", "d_inner")
    xbc_conv = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
    xin, Bm, Cm = torch.split(xbc_conv, [di, st, st], dim=-1)
    dt = softplus(dt_in.to(F32) + p.dt_bias[None, None])
    loga = -torch.exp(p.A_log)[None, None] * dt          # [B,L,nh] ≤ 0
    # The JAX ``xin * dt.repeat(hd, axis=-1)``: each head's hd channels
    # times its dt.
    xh = xin.to(F32).reshape(b, l, nh, hd) * dt[..., None]
    y, h_final = _ssd_chunked(xh, Bm.to(F32), Cm.to(F32), loga, chunk)
    y = y + p.D[None, None, :, None] * xin.to(F32).reshape(b, l, nh, hd)
    y = y.reshape(b, l, di).to(x.dtype)
    y = rms_norm_gated(y, z, p.norm_w)
    k = p.conv_w.shape[0]
    return p.out_proj(y), (_conv_tail(xbc, k), h_final)


def mamba2(p: Mamba2, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x: [B, L, d]."""
    return _mamba2_fwd(p, x, chunk)[0]


def mamba2_prefill(p: Mamba2, x: torch.Tensor, chunk: int = 256):
    """The full-sequence block and its decode state ``(conv [B, K-1,
    di + 2·st], h [B, nh, hd, st])``."""
    return _mamba2_fwd(p, x, chunk)


def mamba2_decode(p: Mamba2, x: torch.Tensor, state,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One-token step; state = (conv [B, K-1, conv_dim], h [B, nh, hd,
    st]), left as it was; the new state goes into ``out`` where given."""
    conv_st, h = state
    di, nh, hd, st = _heads(p)
    z = p.in_z(x)
    xbc = p.in_xbc(x)
    dt_in = p.in_dt(x)
    window = torch.cat([conv_st, xbc], dim=1)
    xc = torch.einsum("bkc,kc->bc", window.to(F32), p.conv_w.to(F32)) \
        + p.conv_b.to(F32)
    xc = F.silu(xc)
    xin, Bm, Cm = torch.split(xc, [di, st, st], dim=-1)          # [B, .]
    dt = softplus(dt_in.to(F32)[:, 0] + p.dt_bias[None])          # [B, nh]
    a = torch.exp(-torch.exp(p.A_log)[None] * dt)                 # [B, nh]
    xh = xin.reshape(-1, nh, hd) * dt[..., None]
    h_new = torch.mul(a[..., None, None], h,
                      out=None if out is None else out[1])
    h_new += xh[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhds,bs->bhd", h_new, Cm)
    y = y + p.D[None, :, None] * xin.reshape(-1, nh, hd)
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = rms_norm_gated(y, z, p.norm_w)
    conv_new = window[:, 1:]
    if out is not None:
        conv_new = out[0].copy_(conv_new)
    return p.out_proj(y), (conv_new, h_new)

