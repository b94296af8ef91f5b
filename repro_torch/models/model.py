"""The decoder stack (``repro.models.model``' counterpart) for the dense
kinds: token embedding, one layer per entry of
``ArchConfig.pattern_for_all_layers()`` (RMSNorm → GQA attention →
RMSNorm → SwiGLU MLP, each with its residual), the final norm and the
output head.

The JAX package stacks the layers of each pattern position and scans
over groups, with ``jax.checkpoint(..., nothing_saveable)`` on each
group; here :class:`Decoder` holds the layers in order and, while
autograd records, runs each group (``len(cfg.layer_pattern)``
consecutive layers) under ``torch.utils.checkpoint(use_reentrant=False)``:
the group's activations are recomputed in the backward pass.  The model
has no dropout and no random op, so the recomputation is exact.

Decode state (the JAX layout, so that the two compare leaf for leaf): a
tuple over the pattern positions, each ``(k, v)`` stacked over the groups
``[G, B, S_c, KVH, hd]``; a ``global`` layer's cache holds ``cache_len``
positions, a ``local`` / ``chunked`` layer's at most ``window`` and
rolls (position p in slot ``p % S_c``).  ``Decoder.forward(batch,
collect_state=True, cache_len=...)`` is the prefill: it runs the groups
without recomputation and returns the caches with the logits;
:func:`decode_step` takes one token a sequence at the absolute position
``pos``, a 0-d tensor on the model's device, so that a decode loop reads
nothing back from the card.  A cache entry's absolute position is
recovered from ``pos`` (:func:`_entry_positions`), so no validity
bookkeeping is stored.

Not ported, each raising ``NotImplementedError`` at construction with
its ROADMAP item: MoE layers (A17c), the ``mamba1`` / ``mamba2`` /
``shared_attn`` kinds (A17d), the ``vision_stub`` / ``audio_stub``
frontends (A17e).

Entry points take ``device=None`` (the card, raising without one) as the
rest of the port does; the weights are drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import DeviceLike, resolve_device
from .layers import (F32, MLP, Attention, RMSNorm, attention, attn_qkv,
                     decode_attention, mlp)

ATTN_KINDS = ("global", "local", "chunked")


def _check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a part of ``cfg`` the port lacks."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP A17c)")
    for kind in cfg.layer_pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet "
                f"(ROADMAP A17d)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP A17e)")


class DecoderLayer(nn.Module):
    """One dense layer: the JAX ``_init_layer`` tree ``ln1``, ``attn``,
    ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, d,
                              cfg.qk_norm, generator, device, dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, generator, device, dtype)


class Decoder(nn.Module):
    """The dense decoder; ``forward(batch) -> (logits, aux)`` with
    ``batch["tokens"]`` [B, L] integer ids and ``aux`` the auxiliary
    loss, 0 for the dense kinds (MoE's load balance is A17c);
    ``forward(batch, collect_state=True, cache_len=S) -> (logits, aux,
    state)`` is the prefill (module docstring)."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator]
                 = None, device: DeviceLike = None, dtype=F32):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        d, v = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = nn.utils.skip_init(nn.Embedding, v, d, device=device,
                                        dtype=dtype)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, d ** -0.5, generator=generator)
        self.lm_head: Optional[nn.Linear] = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.utils.skip_init(nn.Linear, d, v, bias=False,
                                              device=device, dtype=dtype)
            with torch.no_grad():
                self.lm_head.weight.normal_(0.0, d ** -0.5,
                                            generator=generator)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, generator, device, dtype)
            for kind in cfg.pattern_for_all_layers())
        self.final_norm = RMSNorm(d, device, dtype)

    def forward(self, batch: Mapping[str, torch.Tensor],
                collect_state: bool = False, cache_len: Optional[int] = None):
        cfg = self.cfg
        h = embed_inputs(cfg, self, batch)
        l = h.shape[1]
        pos = torch.arange(l, device=h.device)
        per = len(cfg.layer_pattern)
        s_cache = cache_len if cache_len is not None else l
        caches = [[] for _ in range(per)]      # a pattern position's groups
        for g in range(cfg.n_groups):
            group = self.layers[g * per:(g + 1) * per]
            if collect_state:
                for j, lp in enumerate(group):
                    h, kv = _apply_attn_layer(cfg, lp, h, pos, lp.kind)
                    caches[j].append(_fill_kv_cache(
                        kv, _cache_len(cfg, lp.kind, s_cache), l))
            elif torch.is_grad_enabled():
                h = checkpoint(_group_body, cfg, group, h, pos,
                               use_reentrant=False)
            else:
                h = _group_body(cfg, group, h, pos)
        h = self.final_norm(h)
        aux = torch.zeros((), dtype=F32, device=h.device)
        logits = unembed(cfg, self, h)
        if collect_state:
            state = tuple((torch.stack([kv[0] for kv in c]),
                           torch.stack([kv[1] for kv in c])) for c in caches)
            return logits, aux, state
        return logits, aux


def _group_body(cfg: ArchConfig, group, h, pos):
    for lp in group:
        h, _ = _apply_attn_layer(cfg, lp, h, pos, lp.kind)
    return h


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, dtype=F32) -> Decoder:
    """The model for ``cfg`` with N(0, 1/fan_in) weights from
    ``generator`` (on ``device``, the card by default) and unit norms,
    the JAX ``init_params``' distributions."""
    return Decoder(cfg, generator, device, dtype)


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The ndim of parameter ``name``'s leaf in the JAX tree, which
    stacks every leaf of the decoder layers (``Decoder.layers``) over the
    groups, ``[n_groups, ...]``: one axis more than ``p`` there."""
    return p.ndim + 1 if name.startswith("layers.") else p.ndim


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters by name: the tensors a train step updates
    and a checkpoint holds."""
    return dict(model.named_parameters())


def load_params(model: nn.Module, params: Mapping[str, torch.Tensor]
                ) -> None:
    """Copy ``params`` (e.g. restored from a checkpoint) into the model's
    own parameters; a tensor that is already the parameter is left
    alone."""
    own = params_of(model)
    if own.keys() != params.keys():
        raise ValueError(f"parameter names differ: {sorted(own)} vs "
                         f"{sorted(params)}")
    with torch.no_grad():
        for name, p in own.items():
            if params[name] is not p:
                p.copy_(params[name])


# ---------------------------------------------------------------------------
# embedding / layers / head
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, model: Decoder, batch) -> torch.Tensor:
    return F.embedding(batch["tokens"], model.embed.weight)


def unembed(cfg: ArchConfig, model: Decoder, h: torch.Tensor
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ model.embed.weight.T
    return model.lm_head(h)


def _apply_ffn(cfg: ArchConfig, lp: DecoderLayer, h):
    return h + mlp(lp.mlp, lp.ln2(h))


def _apply_attn_layer(cfg: ArchConfig, lp: DecoderLayer, h, pos, kind: str):
    """One layer over the whole sequence; returns (h, (k, v)), the layer's
    keys and values [B, L, KVH, hd] for the prefill's cache."""
    a_in = lp.ln1(h)
    q, k, v = attn_qkv(lp.attn, a_in, pos, n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm)
    o = attention(q, k, v, kind=kind, window=cfg.window)
    b, l = h.shape[:2]
    h = h + lp.attn.wo(o.reshape(b, l, -1))
    return _apply_ffn(cfg, lp, h), (k, v)


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def _cache_len(cfg: ArchConfig, kind: str, s: int) -> int:
    if kind == "global":
        return s
    return min(s, cfg.window)


def _fill_kv_cache(kv, s_c: int, l: int):
    """Pack prefill k/v [B, L, KVH, hd] into a rolling cache of length
    s_c: zero slots after the prompt, or the prompt's last s_c positions
    rolled by ``l % s_c``, so that position p sits in slot ``p % s_c``."""
    def pack(a):
        if s_c >= l:
            return F.pad(a, (0, 0, 0, 0, 0, s_c - l))
        return torch.roll(a[:, l - s_c:], l % s_c, dims=1)

    return tuple(pack(a) for a in kv)


def init_decode_state(cfg: ArchConfig, batch: int, s: int, dtype=F32,
                      device: DeviceLike = None):
    """Empty caches (decode from scratch) in the layout ``forward(...,
    collect_state=True)`` gives: per pattern position, ``(k, v)`` zeros
    ``[G, batch, S_c, KVH, hd]``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    states = []
    for kind in cfg.layer_pattern:
        shp = (cfg.n_groups, batch, _cache_len(cfg, kind, s), cfg.n_kv_heads,
               cfg.hd)
        states.append((torch.zeros(shp, dtype=dtype, device=dev),
                       torch.zeros(shp, dtype=dtype, device=dev)))
    return tuple(states)


def _entry_positions(s_c: int, pos: torch.Tensor) -> torch.Tensor:
    """Absolute position of each rolling-cache slot after writing at
    ``pos``; negative values mark not-yet-written slots."""
    slot = pos % s_c
    i = torch.arange(s_c, device=pos.device)
    return pos - ((slot - i) % s_c)


def _decode_attn(cfg: ArchConfig, ap: Attention, h_in, kv_cache, pos, kind,
                 wo: nn.Linear, out=None):
    """Decode attention: h_in [B, 1, d_in]; returns (attn_out, cache).
    The new key and value go into slot ``pos % S_c`` as a masked select
    on the device (into ``out``'s two tensors where given)."""
    k_c, v_c = kv_cache
    s_c = k_c.shape[1]
    q, k, v = attn_qkv(ap, h_in, pos[None], n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm)
    slot_mask = (torch.arange(s_c, device=pos.device)
                 == pos % s_c)[None, :, None, None]
    if out is None:
        k_c = torch.where(slot_mask, k.to(k_c.dtype), k_c)
        v_c = torch.where(slot_mask, v.to(v_c.dtype), v_c)
    else:
        k_c = torch.where(slot_mask, k.to(k_c.dtype), k_c, out=out[0])
        v_c = torch.where(slot_mask, v.to(v_c.dtype), v_c, out=out[1])
    epos = _entry_positions(s_c, pos)[None, :]
    o = decode_attention(q, k_c, v_c, epos, pos, kind=kind, window=cfg.window)
    b = h_in.shape[0]
    return wo(o.reshape(b, 1, -1)), (k_c, v_c)


def decode_step(cfg: ArchConfig, model: Decoder, state, batch, pos):
    """One decode step.  ``batch["tokens"]``: [B, 1]; ``pos``: the
    absolute position, a 0-d integer tensor on the model's device (an int
    is copied there).  Returns (logits [B, 1, V], new_state); ``state``
    is left as it was."""
    h = embed_inputs(cfg, model, batch)
    pos = torch.as_tensor(pos, device=h.device)
    per = len(cfg.layer_pattern)
    new = tuple((torch.empty_like(k), torch.empty_like(v)) for k, v in state)
    for g in range(cfg.n_groups):
        for j in range(per):
            lp = model.layers[g * per + j]
            o, _ = _decode_attn(cfg, lp.attn, lp.ln1(h),
                                (state[j][0][g], state[j][1][g]), pos,
                                lp.kind, lp.attn.wo,
                                out=(new[j][0][g], new[j][1][g]))
            h = _apply_ffn(cfg, lp, h + o)
    h = model.final_norm(h)
    return unembed(cfg, model, h), new
