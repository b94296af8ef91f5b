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

Not ported, each raising ``NotImplementedError`` at construction with
its ROADMAP item: MoE layers (A17c), the ``mamba1`` / ``mamba2`` /
``shared_attn`` kinds (A17d), the ``vision_stub`` / ``audio_stub``
frontends (A17e); the decode state (``collect_state``,
``init_decode_state``, ``decode_step``) is A17b.

Entry points take ``device=None`` (the card, raising without one) as the
rest of the port does; the weights are drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import DeviceLike, resolve_device
from .layers import F32, MLP, Attention, RMSNorm, attention, attn_qkv, mlp

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
    loss, 0 for the dense kinds (MoE's load balance is A17c)."""

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

    def forward(self, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        h = embed_inputs(cfg, self, batch)
        pos = torch.arange(h.shape[1], device=h.device)
        per = len(cfg.layer_pattern)
        for g in range(cfg.n_groups):
            group = self.layers[g * per:(g + 1) * per]
            if torch.is_grad_enabled():
                h = checkpoint(_group_body, cfg, group, h, pos,
                               use_reentrant=False)
            else:
                h = _group_body(cfg, group, h, pos)
        h = self.final_norm(h)
        aux = torch.zeros((), dtype=F32, device=h.device)
        return unembed(cfg, self, h), aux


def _group_body(cfg: ArchConfig, group, h, pos):
    for lp in group:
        h = _apply_attn_layer(cfg, lp, h, pos, lp.kind)
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
    a_in = lp.ln1(h)
    q, k, v = attn_qkv(lp.attn, a_in, pos, n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm)
    o = attention(q, k, v, kind=kind, window=cfg.window)
    b, l = h.shape[:2]
    h = h + lp.attn.wo(o.reshape(b, l, -1))
    return _apply_ffn(cfg, lp, h)
