"""Meta-device stand-ins and shardings for every (arch x shape) cell
(counterpart of ``repro.launch.specs``): the glue between configs,
models and the mesh.

``batch_specs`` / ``params_specs`` / ``opt_specs`` / ``state_specs``
return tensors on the ``meta`` device (shapes and dtypes, no storage);
``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` /
``decode_state_shardings`` map every tensor of (params, opt, batch,
state) to a :class:`~repro_torch.distributed.sharding.NamedSharding`
by the JAX rules, and :func:`place` makes DTensors of them.

The rules are the JAX package's, first match wins, written over the
JAX tree's leaf paths: a port parameter is looked up under its JAX leaf
(``models.model.reference_path``), the JAX leaf's leading group axis is
dropped where the JAX tree stacks the layers, and the spec is reversed
where the port holds the transpose (an ``nn.Linear`` weight ``[out,
in]`` of a JAX ``[in, out]`` matrix).  So JAX's ``['wq'] -> (None,
mp)`` is ``(mp, None)`` on the port's ``wq.weight``, while the MoE
weights, which keep the JAX layouts, keep ``(mp, None, None)``.

The batch's token ids are int64 here (the port's data pipeline and
``F.embedding``'s index type) where the JAX batch holds int32.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs.base import ArchConfig, ShapeConfig
from ..distributed.sharding import NamedSharding, Spec
from ..models import model as M
from ..serve.lm import make_decode_step, make_prefill_step
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import make_train_step

META = torch.device("meta")
I64, F32, BF16 = torch.int64, torch.float32, torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# stand-ins on the meta device (no allocation anywhere)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.frontend == "audio_stub":
            return {"tokens": _meta((b, 1, cfg.n_codebooks), I64)}
        return {"tokens": _meta((b, 1), I64)}
    if cfg.frontend == "audio_stub":
        out = {"tokens": _meta((b, l, cfg.n_codebooks), I64),
               "labels": _meta((b, l, cfg.n_codebooks), I64)}
    elif cfg.frontend == "vision_stub":
        out = {"tokens": _meta((b, l - cfg.n_patches), I64),
               "patch_emb": _meta((b, cfg.n_patches, cfg.d_model), F32),
               "labels": _meta((b, l), I64)}
    else:
        out = {"tokens": _meta((b, l), I64), "labels": _meta((b, l), I64)}
    if shape.kind == "train":
        out["loss_mask"] = _meta((b, l), F32)
    else:                     # prefill uses tokens (+patches) only
        out.pop("labels")
    return out


def params_specs(cfg: ArchConfig, dtype=BF16) -> M.Decoder:
    """The model with its parameters on the meta device."""
    return M.init_params(cfg, torch.Generator().manual_seed(0), device=META,
                         dtype=dtype)


def opt_specs(cfg: ArchConfig, model: nn.Module, opt_cfg: OptConfig):
    return init_opt_state(M.params_of(model), opt_cfg)


def state_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=BF16):
    return M.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                               dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def axes_of(names) -> Tuple[Any, Optional[str]]:
    """``(dp, mp)`` of a mesh with these dimension names: the data axes
    (a name, a tuple of names or None) and the model axis."""
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    mp = "model" if "model" in names else None
    return dp, mp


def _axes(mesh: DeviceMesh):
    return axes_of(mesh.mesh_dim_names)


# JAX leaf path regex -> spec builder (dp=data axes, mp=model axis); first
# match wins, so the MoE (leading expert axis) rules come first.
_PARAM_RULES = [
    (r"moe.*\['wi'\]$",   lambda dp, mp: (mp, None, None)),
    (r"moe.*\['wg'\]$",   lambda dp, mp: (mp, None, None)),
    (r"moe.*\['wo'\]$",   lambda dp, mp: (mp, None, None)),
    (r"\['router'\]$",    lambda dp, mp: (None, None)),
    # attention / shared-attention projections
    (r"\['wq'\]$",        lambda dp, mp: (None, mp)),
    (r"\['wk'\]$",        lambda dp, mp: (None, None)),   # kv replicated (GQA)
    (r"\['wv'\]$",        lambda dp, mp: (None, None)),
    (r"\['wo'\]$",        lambda dp, mp: (mp, None)),
    # dense mlp
    (r"\['wi'\]$",        lambda dp, mp: (None, mp)),
    (r"\['wg'\]$",        lambda dp, mp: (None, mp)),
    # ssm
    (r"\['in_x'\]$",      lambda dp, mp: (None, mp)),
    (r"\['in_z'\]$",      lambda dp, mp: (None, mp)),
    (r"\['in_xbc'\]$",    lambda dp, mp: (None, None)),   # mixed di+2st cols
    (r"\['in_dt'\]$",     lambda dp, mp: (None, mp)),
    (r"\['x_proj'\]$",    lambda dp, mp: (mp, None)),
    (r"\['dt_proj'\]$",   lambda dp, mp: (None, mp)),
    (r"\['out_proj'\]$",  lambda dp, mp: (mp, None)),
    # embeddings / heads
    (r"\['embed'\]$",     lambda dp, mp: (mp, None)),
    (r"\['lm_head'\]$",   lambda dp, mp: (None, mp)),
    (r"\['vision_proj'\]$", lambda dp, mp: (None, None)),
]


def reference_param_spec(path_str: str, ndim: int, dp, mp,
                         cfg: ArchConfig) -> Spec:
    """The JAX ``_param_spec``: the spec of the JAX leaf at ``path_str``
    (``ndim`` its rank, the group axis included)."""
    for pat, fn in _PARAM_RULES:
        if re.search(pat, path_str):
            base = list(fn(dp, mp))
            if "groups" in path_str:          # stacked [G, ...] leaves
                base = [None] + base
            if cfg.frontend == "audio_stub" and \
                    re.search(r"\['(embed|lm_head)'\]$", path_str):
                base = [None] + base          # leading codebook axis
            base = base[:ndim] + [None] * (ndim - len(base))
            return tuple(base)
    return (None,) * ndim                     # norms, scalars, biases


def param_spec(cfg: ArchConfig, name: str, p: torch.Tensor, dp, mp) -> Spec:
    """The spec of the port's parameter ``name``: its JAX leaf's, the
    group axis dropped and transposed with the tensor."""
    path, stacked, transposed = M.reference_path(cfg, name)
    spec = reference_param_spec(path, p.ndim + stacked, dp, mp, cfg)
    if stacked:
        spec = spec[1:]
    return spec[::-1] if transposed else spec


def param_shardings(cfg: ArchConfig, params, mesh: DeviceMesh
                    ) -> Dict[str, NamedSharding]:
    """``params`` (a model or a name -> tensor mapping) -> shardings."""
    if isinstance(params, nn.Module):
        params = M.params_of(params)
    dp, mp = _axes(mesh)
    return {n: NamedSharding(mesh, param_spec(cfg, n, p, dp, mp))
            for n, p in params.items()}


def opt_shardings(cfg: ArchConfig, opt_tree, mesh: DeviceMesh):
    """Moments mirror the parameter shardings; step is replicated."""
    return {"m": param_shardings(cfg, opt_tree["m"], mesh),
            "v": param_shardings(cfg, opt_tree["v"], mesh),
            "step": NamedSharding(mesh, ())}


def batch_spec(shape: ShapeConfig, ndim: int, dp) -> Spec:
    """A batch tensor's spec: its batch dim over the data axes (not for
    a batch of one)."""
    return (dp if shape.global_batch > 1 else None,) + (None,) * (ndim - 1)


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, batch_tree,
                    mesh: DeviceMesh) -> Dict[str, NamedSharding]:
    dp, _ = _axes(mesh)
    return {k: NamedSharding(mesh, batch_spec(shape, x.ndim, dp))
            for k, x in batch_tree.items()}


def state_spec(shape: Tuple[int, ...], dp, mp, long_ctx: bool,
                all_axes) -> Spec:
    """The JAX ``assign_safe``: a decode-state leaf's spec from its shape.
    A 5-D leaf is a KV cache ``[G, B, S, KVH, hd]`` where ``S >= 512``,
    else a Mamba-2 state ``[G, B, nh, hd, st]`` (the JAX heuristic)."""
    ndim = len(shape)
    bdp = None if long_ctx else dp
    if ndim == 5 and shape[2] >= 512:                 # big axis = sequence
        if long_ctx:
            return (None, None, all_axes, None, None)
        return (None, dp, mp, None, None)
    if ndim == 5:                                     # mamba2 state
        return (None, bdp, mp, None, None)
    if ndim == 4:                                     # conv [G,B,K-1,C] or
        if shape[2] <= 8:                             # mamba1 h [G,B,di,st]
            return (None, bdp, None, mp)
        return (None, bdp, mp, None)
    if ndim == 3:
        return (None, bdp, mp)
    return (None,) * ndim


def decode_state_shardings(cfg: ArchConfig, shape: ShapeConfig, state_tree,
                           mesh: DeviceMesh):
    """Caches: batch over the data axes, the long-context (batch 1) cell
    shards the sequence axis over everything (sequence-parallel decode);
    SSM states shard d_inner / heads over model.  ``state_tree`` is the
    decode state (a tuple of pairs); the result has its structure."""
    dp, mp = _axes(mesh)
    long_ctx = shape.global_batch == 1
    all_axes = tuple(mesh.mesh_dim_names)
    return tuple(tuple(NamedSharding(mesh, state_spec(
        tuple(leaf.shape), dp, mp, long_ctx, all_axes)) for leaf in entry)
        for entry in state_tree)


# ---------------------------------------------------------------------------
# placing tensors and assembling a cell
# ---------------------------------------------------------------------------

def place(x: torch.Tensor, sh: NamedSharding) -> DTensor:
    """``x`` (the whole tensor, the same on every rank) as a DTensor
    placed by ``sh``: each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)


def place_tree(tree, shardings):
    """``tree`` (nested dicts / tuples of tensors) placed leaf by leaf
    by the matching ``shardings``; a leaf whose sharding is None is left
    as it is."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_tree(v, s) for v, s in zip(tree, shardings))
    return tree if shardings is None else place(tree, shardings)


def place_model(model: nn.Module, shardings: Dict[str, NamedSharding]
                ) -> nn.Module:
    """Replace every parameter of ``model`` by its DTensor placed by
    ``shardings`` (by parameter name), in place; returns ``model``."""
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, nn.Parameter(place(p.detach(), shardings[name]),
                                        requires_grad=p.requires_grad))
    return model


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: DeviceMesh,
               opt_cfg: Optional[OptConfig] = None, dtype=BF16
               ) -> Tuple[Any, Tuple, Tuple]:
    """``(fn, args, shardings)``: the cell's step function, its meta
    stand-in arguments (the model first) and, for each argument, its
    shardings (the model's by parameter name; None for a replicated
    host value).  :func:`place_args` places them."""
    if opt_cfg is None:
        opt_cfg = OptConfig(moment_dtype=cfg.moment_dtype)
    model = params_specs(cfg, dtype)
    p_sh = param_shardings(cfg, model, mesh)
    b_specs = batch_specs(cfg, shape)
    b_sh = batch_shardings(cfg, shape, b_specs, mesh)
    if shape.kind == "train":
        o_specs = opt_specs(cfg, model, opt_cfg)
        fn = make_train_step(cfg, opt_cfg, microbatches=shape.microbatches)
        return (fn, (model, o_specs, b_specs),
                (p_sh, opt_shardings(cfg, o_specs, mesh), b_sh))
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, cache_len=shape.seq_len)
        return fn, (model, b_specs), (p_sh, b_sh)
    fn = make_decode_step(cfg)
    s_specs = state_specs(cfg, shape, dtype)
    s_sh = decode_state_shardings(cfg, shape, s_specs, mesh)
    if shape.global_batch == 1:                 # long context: replicated
        b_sh = {k: NamedSharding(mesh, (None,) * x.ndim)
                for k, x in b_specs.items()}
    pos = _meta((), I64)           # a host-side value: not placed
    return fn, (model, s_specs, b_specs, pos), (p_sh, s_sh, b_sh, None)


def place_args(args: Tuple, shardings: Tuple) -> Tuple:
    """:func:`build_cell`'s arguments placed on the mesh: the model's
    parameters replaced by DTensors, every other tensor placed."""
    model, *rest = args
    p_sh, *rest_sh = shardings
    return (place_model(model, p_sh),) + tuple(
        place_tree(a, s) for a, s in zip(rest, rest_sh))
