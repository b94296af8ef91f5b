"""The decoder stack (``repro.models.model``' counterpart): token
embedding, one layer per entry of ``ArchConfig.pattern_for_all_layers()``,
the final norm and the output head.  Layer kinds:

* ``global`` / ``local`` / ``chunked``: RMSNorm → GQA attention →
  RMSNorm → SwiGLU MLP, or with ``n_experts`` the MoE layer
  (``models.moe``), plus a dense MLP beside it for arctic's
  ``moe_dense_residual`` and llama4's ``shared_expert``;
* ``mamba1`` / ``mamba2``: RMSNorm → the SSM block (``models.ssm``);
* ``mamba2+shared_attn`` (zamba2): the Mamba-2 layer, then the one
  weight-shared attention block (:class:`SharedAttn`, held once by the
  decoder outside ``layers``) on ``concat[h, x_embed]``.

``forward`` returns the logits and ``aux``, the sum of the MoE layers'
load-balancing losses (0 without experts).

The JAX package stacks the layers of each pattern position and scans
over groups, with ``jax.checkpoint(..., nothing_saveable)`` on each
group; here :class:`Decoder` holds the layers in order and, while
autograd records, runs each group (``len(cfg.layer_pattern)``
consecutive layers) under ``torch.utils.checkpoint(use_reentrant=False)``:
the group's activations are recomputed in the backward pass.  The model
has no dropout and no random op, and the MoE dispatch is a function of
its inputs, so the recomputation is exact.

Decode state (the JAX layout, so that the two compare leaf for leaf): a
tuple with one entry per pattern position, and a second one after a
``mamba2+shared_attn`` position's for the shared block's cache, each a
pair stacked over the groups: an attention cache ``(k, v)`` ``[G, B,
S_c, KVH, hd]``, ``global`` holding ``cache_len`` positions, ``local`` /
``chunked`` at most ``window`` and rolling (position p in slot ``p %
S_c``); a ``mamba1`` state ``(conv [G, B, K-1, di], h [G, B, di, st])``;
a ``mamba2`` state ``(conv [G, B, K-1, di + 2·st], h [G, B, nh, hd,
st])``, ``h`` in float32.  ``Decoder.forward(batch, collect_state=True,
cache_len=...)`` is the prefill: it runs the groups without
recomputation and returns the states with the logits; :func:`decode_step`
takes one token a sequence at the absolute position ``pos``, a 0-d
tensor on the model's device, writes the new state into tensors it
allocates and reads nothing back from the card.  A cache entry's
absolute position is recovered from ``pos`` (:func:`_entry_positions`),
so no validity bookkeeping is stored.

The frontends (the JAX stubs, ``docs/design.md`` §4): ``vision_stub``
projects a batch's precomputed ``patch_emb`` [B, P, d] through
``vision_proj`` and puts it before the text tokens' embeddings (a decode
step is text only, at absolute positions that count the patches);
``audio_stub`` embeds ``tokens`` [B, L, nc] as the sum over codebooks of
``embed.weight[c]`` [nc, V, d] rows, in codebook order, and its head
``lm_head.weight`` [nc, d, V] gives logits [B, L, nc, V].

Entry points take ``device=None`` (the card, raising without one) as the
rest of the port does; the weights are drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import DeviceLike, resolve_device
from ..distributed.sharding import get_mesh, like, shard, unsharded
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (F32, MLP, Attention, RMSNorm, attention, attn_qkv,
                     decode_attention, mlp)

ATTN_KINDS = ("global", "local", "chunked")


def is_attn_kind(kind: str) -> bool:
    return kind in ATTN_KINDS


def base_kind(kind: str) -> str:
    return kind.split("+")[0]


class Codebooks(nn.Module):
    """``audio_stub``'s per-codebook tables: ``weight`` [nc, rows, cols]
    drawn N(0, std²), the embeddings [nc, V, d] and the heads [nc, d, V]
    (the JAX leaves' own layout)."""

    def __init__(self, nc: int, rows: int, cols: int, std: float, generator,
                 device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((nc, rows, cols),
                                               device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)


class DecoderLayer(nn.Module):
    """One layer: the JAX ``_init_layer`` tree.  An attention layer holds
    ``ln1``, ``attn``, ``ln2`` and ``mlp``, or ``moe`` (with ``dense``
    for ``moe_dense_residual`` / ``shared_expert``); a ``mamba1`` /
    ``mamba2`` layer holds ``ln`` and ``m``."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        bk = base_kind(kind)
        if is_attn_kind(bk):
            self.ln1 = RMSNorm(d, device, dtype)
            self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, d,
                                  cfg.qk_norm, generator, device, dtype)
            self.ln2 = RMSNorm(d, device, dtype)
            if cfg.n_experts > 0:
                self.moe = moe_mod.MoE(d, cfg.d_ff, cfg.n_experts, generator,
                                       device, dtype)
                if cfg.moe_dense_residual or cfg.shared_expert:
                    self.dense = MLP(d, cfg.d_ff, generator, device, dtype)
            else:
                self.mlp = MLP(d, cfg.d_ff, generator, device, dtype)
        elif bk in ("mamba1", "mamba2"):
            self.ln = RMSNorm(d, device, dtype)
            block = ssm_mod.Mamba1 if bk == "mamba1" else ssm_mod.Mamba2
            self.m = block(cfg, generator, device, dtype)
        else:
            raise ValueError(kind)


class SharedAttn(nn.Module):
    """zamba2's one weight-shared block (the JAX ``_init_shared_attn``):
    ``ln1`` [2d] and attention from the ``2d`` inputs ``concat[h,
    x_embed]`` back to d, ``ln2`` [d] and a SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, generator, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(2 * d, device, dtype)
        self.attn = Attention(2 * d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, d,
                              cfg.qk_norm, generator, device, dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, generator, device, dtype)


class Decoder(nn.Module):
    """The decoder; ``forward(batch) -> (logits, aux)`` with
    ``batch["tokens"]`` [B, L] integer ids (audio [B, L, nc]; a vision
    batch may add ``patch_emb``) and ``aux`` the MoE layers'
    summed load-balancing loss (0 without experts); ``forward(batch,
    collect_state=True, cache_len=S) -> (logits, aux, state)`` is the
    prefill (module docstring)."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator]
                 = None, device: DeviceLike = None, dtype=F32):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        d, v = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.lm_head: Optional[nn.Module] = None
        self.vision_proj: Optional[nn.Linear] = None
        if cfg.frontend == "audio_stub":
            nc = cfg.n_codebooks
            self.embed = Codebooks(nc, v, d, d ** -0.5, generator, device,
                                   dtype)
            self.lm_head = Codebooks(nc, d, v, d ** -0.5, generator, device,
                                     dtype)
        else:
            self.embed = nn.utils.skip_init(nn.Embedding, v, d,
                                            device=device, dtype=dtype)
            with torch.no_grad():
                self.embed.weight.normal_(0.0, d ** -0.5,
                                          generator=generator)
        if cfg.frontend == "vision_stub":
            self.vision_proj = nn.utils.skip_init(
                nn.Linear, d, d, bias=False, device=device, dtype=dtype)
            with torch.no_grad():
                self.vision_proj.weight.normal_(0.0, d ** -0.5,
                                                generator=generator)
        if not cfg.tie_embeddings and self.lm_head is None:
            self.lm_head = nn.utils.skip_init(nn.Linear, d, v, bias=False,
                                              device=device, dtype=dtype)
            with torch.no_grad():
                self.lm_head.weight.normal_(0.0, d ** -0.5,
                                            generator=generator)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, generator, device, dtype)
            for kind in cfg.pattern_for_all_layers())
        self.shared_attn: Optional[SharedAttn] = None
        if any("shared_attn" in k for k in cfg.layer_pattern):
            self.shared_attn = SharedAttn(cfg, generator, device, dtype)
        self.final_norm = RMSNorm(d, device, dtype)

    def forward(self, batch: Mapping[str, torch.Tensor],
                collect_state: bool = False, cache_len: Optional[int] = None):
        cfg = self.cfg
        h = embed_inputs(cfg, self, batch)
        x0 = h
        l = h.shape[1]
        pos = torch.arange(l, device=h.device)
        per = len(cfg.layer_pattern)
        s_cache = cache_len if cache_len is not None else l
        aux = like(torch.zeros((), dtype=F32, device=h.device), h)
        entries: List[List[Tuple[torch.Tensor, torch.Tensor]]] = [
            [] for _ in state_kinds(cfg)]     # an entry's groups
        for g in range(cfg.n_groups):
            group = self.layers[g * per:(g + 1) * per]
            if collect_state:
                h, aux, states = _group_body(cfg, group, self.shared_attn, h,
                                             x0, pos, aux, s_cache)
                for e, st in zip(entries, states):
                    e.append(st)
            elif torch.is_grad_enabled():
                h, aux = checkpoint(_group_body, cfg, group, self.shared_attn,
                                    h, x0, pos, aux, use_reentrant=False)
            else:
                h, aux = _group_body(cfg, group, self.shared_attn, h, x0, pos,
                                     aux)
        h = self.final_norm(h)
        logits = unembed(cfg, self, h)
        if collect_state:
            state = tuple((torch.stack([st[0] for st in e]),
                           torch.stack([st[1] for st in e])) for e in entries)
            return logits, aux, state
        return logits, aux


def state_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """The kind of each decode-state entry, in order: a pattern
    position's base kind, and ``"shared"`` after a ``+shared_attn``
    position's (the shared block's global cache)."""
    out = []
    for kind in cfg.layer_pattern:
        out.append(base_kind(kind))
        if "shared_attn" in kind:
            out.append("shared")
    return tuple(out)


def _group_body(cfg: ArchConfig, group, shared, h, x0, pos, aux,
                s_cache: Optional[int] = None):
    """One group of layers over the whole sequence; returns (h, aux), and
    with ``s_cache`` (the prefill) also the group's decode-state entries
    for caches of ``s_cache`` positions."""
    l = h.shape[1]
    states = []
    for lp in group:
        bk = base_kind(lp.kind)
        if is_attn_kind(bk):
            h, kv, a = _apply_attn_layer(cfg, lp, h, pos, bk)
            if a is not None:
                aux = aux + a
            if s_cache is not None:
                states.append(_fill_kv_cache(kv, _cache_len(cfg, bk, s_cache),
                                             l))
        else:
            m_in = lp.ln(h)
            fwd = (ssm_mod.mamba1_prefill if bk == "mamba1"
                   else ssm_mod.mamba2_prefill)
            y, st = fwd(lp.m, m_in)
            h = h + y
            if s_cache is not None:
                states.append(st)
        if "shared_attn" in lp.kind:
            h, kv = _apply_shared_attn(cfg, shared, h, x0, pos)
            if s_cache is not None:
                states.append(_fill_kv_cache(
                    kv, _cache_len(cfg, "global", s_cache), l))
        h = shard(h, "batch", "seq", "d_model")
    if s_cache is not None:
        return h, aux, states
    return h, aux


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, dtype=F32) -> Decoder:
    """The model for ``cfg`` with the JAX ``init_params``' distributions,
    drawn from ``generator`` (on ``device``, the card by default): N(0,
    1/fan_in) matrices, unit norms and the SSM blocks' fixed leaves."""
    return Decoder(cfg, generator, device, dtype)


# A layer's JAX leaves (and the shared block's) and their names in
# this module; True where the leaf is an ``x @ w`` matrix
# (transposed).  A layer has the leaves of its kind.
LAYER_LEAVES = (
    (("ln1",), "ln1.weight", False),
    (("ln2",), "ln2.weight", False),
    (("attn", "wq"), "attn.wq.weight", True),
    (("attn", "wk"), "attn.wk.weight", True),
    (("attn", "wv"), "attn.wv.weight", True),
    (("attn", "wo"), "attn.wo.weight", True),
    (("attn", "q_norm"), "attn.q_norm.weight", False),
    (("attn", "k_norm"), "attn.k_norm.weight", False),
    (("mlp", "wi"), "mlp.wi.weight", True),
    (("mlp", "wg"), "mlp.wg.weight", True),
    (("mlp", "wo"), "mlp.wo.weight", True),
    (("dense", "wi"), "dense.wi.weight", True),
    (("dense", "wg"), "dense.wg.weight", True),
    (("dense", "wo"), "dense.wo.weight", True),
    (("moe", "router"), "moe.router", False),
    (("moe", "wi"), "moe.wi", False),
    (("moe", "wg"), "moe.wg", False),
    (("moe", "wo"), "moe.wo", False),
    (("ln",), "ln.weight", False),
    (("m", "in_x"), "m.in_x.weight", True),
    (("m", "in_z"), "m.in_z.weight", True),
    (("m", "in_xbc"), "m.in_xbc.weight", True),
    (("m", "in_dt"), "m.in_dt.weight", True),
    (("m", "conv_w"), "m.conv_w", False),
    (("m", "conv_b"), "m.conv_b", False),
    (("m", "x_proj"), "m.x_proj.weight", True),
    (("m", "dt_proj"), "m.dt_proj.weight", True),
    (("m", "dt_bias"), "m.dt_bias", False),
    (("m", "A_log"), "m.A_log", False),
    (("m", "D"), "m.D", False),
    (("m", "norm_w"), "m.norm_w", False),
    (("m", "out_proj"), "m.out_proj.weight", True),
)


def reference_path(cfg: ArchConfig, name: str) -> Tuple[str, bool, bool]:
    """Where parameter ``name`` sits in the JAX tree: ``(path, stacked,
    transposed)``, ``path`` the leaf's ``jax.tree_util.keystr`` (a
    decoder layer's under ``['groups'][j]``, ``j`` its pattern
    position), ``stacked`` where the leaf stacks the layers of that
    position ``[n_groups, ...]`` and ``transposed`` where the JAX leaf is
    this tensor's transpose (an ``nn.Linear`` weight of an ``x @ w``
    matrix, the 2-D ``lm_head`` and ``vision_proj``)."""
    head, _, rest = name.partition(".")
    if head in ("embed", "lm_head", "vision_proj", "final_norm"):
        matrix = head == "vision_proj" or (
            head == "lm_head" and cfg.frontend != "audio_stub")
        return f"[{head!r}]", False, matrix
    if head == "layers":
        i, _, rest = rest.partition(".")
        prefix = f"['groups'][{int(i) % len(cfg.layer_pattern)}]"
    elif head == "shared_attn":
        prefix = "['shared_attn']"
    else:
        raise KeyError(name)
    for path, leaf, matrix in LAYER_LEAVES:
        if leaf == rest:
            return (prefix + "".join(f"[{k!r}]" for k in path),
                    head == "layers", matrix)
    raise KeyError(name)


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The ndim of parameter ``name``'s leaf in the JAX tree, which
    stacks every leaf of the decoder layers (``Decoder.layers``) over the
    groups, ``[n_groups, ...]``: one axis more than ``p`` there.  The
    shared block (``shared_attn.``) is not stacked."""
    return p.ndim + 1 if name.startswith("layers.") else p.ndim


def reference_leaves(cfg: ArchConfig, names) -> List[Tuple[str, ...]]:
    """The parameter ``names`` grouped by the leaf of the JAX tree that
    holds them: a decoder layer's tensor is stacked there with the same
    tensor of every layer at its pattern position (``layers.{i}.`` with
    one ``i % len(cfg.layer_pattern)``), in the order of ``names``;
    every other parameter is a leaf of its own."""
    per = len(cfg.layer_pattern)
    leaves: Dict[object, List[str]] = {}
    for name in names:
        head, _, rest = name.partition(".")
        key = name
        if head == "layers":
            i, _, rest = rest.partition(".")
            key = (int(i) % per, rest)
        leaves.setdefault(key, []).append(name)
    return [tuple(v) for v in leaves.values()]


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
    """The stack's input [B, L, d]: the tokens' embeddings; for audio
    their sum over codebooks, for a vision batch that holds
    ``patch_emb`` the projected patches before them."""
    # On a mesh the table is gathered whole over the axes that shard its
    # vocabulary first: DTensor's lookup in a row-sharded table makes a
    # masked partial sum whose gradient it cannot redistribute.
    w = unsharded(model.embed.weight, model.embed.weight.ndim - 2)
    if cfg.frontend == "audio_stub":
        codes = batch["tokens"]                              # [B, L, nc]
        h = F.embedding(codes[:, :, 0], w[0])
        for c in range(1, cfg.n_codebooks):
            h = h + F.embedding(codes[:, :, c], w[c])
    else:
        h = F.embedding(batch["tokens"], w)
        if cfg.frontend == "vision_stub" and "patch_emb" in batch:
            patch = model.vision_proj(batch["patch_emb"].to(h.dtype))
            h = torch.cat([patch, h], dim=1)
    return shard(h, "batch", "seq", "d_model")


def unembed(cfg: ArchConfig, model: Decoder, h: torch.Tensor
            ) -> torch.Tensor:
    """The logits [B, L, V]; audio [B, L, nc, V], one head a codebook."""
    if cfg.frontend == "audio_stub":
        logits = torch.einsum("bld,cdv->blcv", h, model.lm_head.weight)
        return shard(logits, "batch", "seq", "codebooks", "vocab")
    if cfg.tie_embeddings:
        logits = h @ model.embed.weight.T
    else:
        logits = model.lm_head(h)
    return shard(logits, "batch", "seq", "vocab")


def _apply_ffn(cfg: ArchConfig, lp: DecoderLayer, h):
    """The layer's second half: (h + FFN(ln2(h)), aux), the FFN the MLP
    or the MoE layer (plus the dense MLP beside it where the layer has
    one), aux the MoE layer's load-balancing loss (None for an MLP)."""
    f_in = lp.ln2(h)
    if cfg.n_experts > 0:
        y, aux = moe_mod.moe_layer(lp.moe, f_in, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
        if hasattr(lp, "dense"):
            y = y + mlp(lp.dense, f_in)
        return h + y, aux
    return h + mlp(lp.mlp, f_in), None


def _apply_attn_layer(cfg: ArchConfig, lp: DecoderLayer, h, pos, kind: str):
    """One layer over the whole sequence; returns (h, (k, v), aux): the
    layer's keys and values [B, L, KVH, hd] for the prefill's cache and
    ``_apply_ffn``'s aux."""
    a_in = lp.ln1(h)
    q, k, v = attn_qkv(lp.attn, a_in, pos, n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm)
    o = attention(q, k, v, kind=kind, window=cfg.window)
    b, l = h.shape[:2]
    h = h + lp.attn.wo(o.reshape(b, l, -1))
    h, aux = _apply_ffn(cfg, lp, h)
    return h, (k, v), aux


def _apply_shared_attn(cfg: ArchConfig, sp: SharedAttn, h, x0, pos):
    """The shared block over the whole sequence on ``concat[h, x0]``;
    returns (h, (k, v))."""
    a_in = sp.ln1(torch.cat([h, x0], dim=-1))
    q, k, v = attn_qkv(sp.attn, a_in, pos, n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm)
    o = attention(q, k, v, kind="global", window=cfg.window)
    b, l = h.shape[:2]
    h = h + sp.attn.wo(o.reshape(b, l, -1))
    h = h + mlp(sp.mlp, sp.ln2(h))
    return h, (k, v)


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
    """Empty states (decode from scratch) in the layout ``forward(...,
    collect_state=True)`` gives (module docstring): zeros, the SSM ``h``
    in float32 and the rest in ``dtype``."""
    dev = resolve_device(device)
    g, kvh, hd = cfg.n_groups, cfg.n_kv_heads, cfg.hd
    di, st, k = cfg.di, cfg.ssm_state, cfg.ssm_conv

    def zeros(*shape, dt=dtype):
        return torch.zeros((g, batch) + shape, dtype=dt, device=dev)

    states = []
    for kind in state_kinds(cfg):
        if kind == "mamba1":
            states.append((zeros(k - 1, di), zeros(di, st, dt=F32)))
        elif kind == "mamba2":
            nh = di // cfg.ssm_head_dim
            states.append((zeros(k - 1, di + 2 * st),
                           zeros(nh, cfg.ssm_head_dim, st, dt=F32)))
        else:
            s_c = _cache_len(cfg, "global" if kind == "shared" else kind, s)
            states.append((zeros(s_c, kvh, hd), zeros(s_c, kvh, hd)))
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
    q = shard(q, "batch", None, None, None)
    slot_mask = like((torch.arange(s_c, device=pos.device)
                      == pos % s_c)[None, :, None, None], k_c)
    if out is None:
        k_c = torch.where(slot_mask, k.to(k_c.dtype), k_c)
        v_c = torch.where(slot_mask, v.to(v_c.dtype), v_c)
    else:
        k_c = torch.where(slot_mask, k.to(k_c.dtype), k_c, out=out[0])
        v_c = torch.where(slot_mask, v.to(v_c.dtype), v_c, out=out[1])
    k_c = shard(k_c, "batch", "kv_seq", "kv_heads", "head_dim")
    v_c = shard(v_c, "batch", "kv_seq", "kv_heads", "head_dim")
    epos = _entry_positions(s_c, pos)[None, :]
    o = decode_attention(q, k_c, v_c, epos, pos, kind=kind, window=cfg.window)
    b = h_in.shape[0]
    return wo(o.reshape(b, 1, -1)), (k_c, v_c)


def decode_step(cfg: ArchConfig, model: Decoder, state, batch, pos):
    """One decode step.  ``batch["tokens"]``: [B, 1] (audio [B, 1, nc]);
    ``pos``: the absolute position, a 0-d integer tensor on the model's
    device (an int is copied there), counting a vision prompt's patches.
    Returns (logits [B, 1, V] (audio [B, 1, nc, V]), new_state); ``state``
    is left as it was.  An MoE layer routes the step's B tokens at the
    capacity of B tokens (the JAX semantics).  Under a mesh the new state
    is stacked from each group's (a sharded cache is not written through
    views); without one each group writes into the state's new tensors."""
    h = embed_inputs(cfg, model, batch)
    x0 = h
    pos = torch.as_tensor(pos, device=h.device)
    per = len(cfg.layer_pattern)
    shared = model.shared_attn
    stacked = get_mesh() is not None
    new = None if stacked else tuple(
        (torch.empty_like(a), torch.empty_like(b)) for a, b in state)
    parts = [([], []) for _ in state]

    def slot(ci, g):
        """(the entry's current state, where its new state goes)."""
        cur = (state[ci][0][g], state[ci][1][g])
        return cur, None if stacked else (new[ci][0][g], new[ci][1][g])

    def keep(ci, st):
        if stacked:
            parts[ci][0].append(st[0])
            parts[ci][1].append(st[1])

    for g in range(cfg.n_groups):
        ci = 0
        for j in range(per):
            lp = model.layers[g * per + j]
            bk = base_kind(lp.kind)
            cur, out = slot(ci, g)
            if is_attn_kind(bk):
                o, st = _decode_attn(cfg, lp.attn, lp.ln1(h), cur, pos, bk,
                                     lp.attn.wo, out=out)
                h, _ = _apply_ffn(cfg, lp, h + o)
            else:
                dec = (ssm_mod.mamba1_decode if bk == "mamba1"
                       else ssm_mod.mamba2_decode)
                y, st = dec(lp.m, lp.ln(h), cur, out=out)
                h = h + y
            keep(ci, st)
            ci += 1
            if "shared_attn" in lp.kind:
                a_in = shared.ln1(torch.cat([h, x0], dim=-1))
                cur, out = slot(ci, g)
                o, st = _decode_attn(cfg, shared.attn, a_in, cur, pos,
                                     "global", shared.attn.wo, out=out)
                keep(ci, st)
                h = h + o
                h = h + mlp(shared.mlp, shared.ln2(h))
                ci += 1
    if stacked:
        new = tuple((torch.stack(a), torch.stack(b)) for a, b in parts)
    h = model.final_norm(h)
    return unembed(cfg, model, h), new
