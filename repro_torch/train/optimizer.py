"""AdamW with a configurable moment dtype (``repro.train.optimizer``'
counterpart), each step the JAX formula:

* the gradients clipped by ``min(1, clip / max(‖g‖, 1e-9))``, ``‖g‖``
  the global norm over every leaf in float32;
* the learning rate ``_schedule`` at the step count *before* the
  increment (linear warm-up);
* bias corrections ``1 − β^t`` at the incremented count, in float32;
* decoupled weight decay where the JAX leaf has ``ndim >= 2``
  (:func:`decays`): the matrices, and every leaf of a decoder layer,
  norm weights included, since the JAX tree stacks a layer's leaves
  ``[n_groups, ...]``; not the final norm;
* the update maths in float32, the moments stored in ``moment_dtype``
  (rounded back after each step).

It is not ``torch.optim.AdamW``, which differs on each of those points
but the first.  The state is ``{"m": {name: tensor}, "v": {...},
"step": int32 0-d tensor}``, keyed as the parameters; ``apply_updates``
writes the new parameters and moments into their tensors in place and
returns them with the metrics, as the JAX function returns its new
trees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch

from ..models.model import reference_ndim

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def moment_dtype(cfg: OptConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def init_opt_state(params: Mapping[str, torch.Tensor], cfg: OptConfig
                   ) -> Dict[str, Any]:
    mdt = moment_dtype(cfg)
    dev = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def decays(name: str, p: torch.Tensor) -> bool:
    """The JAX ``p.ndim >= 2``, on the leaf's JAX counterpart
    (``models.model.reference_ndim``)."""
    return reference_ndim(name, p) >= 2


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max((step + 1) / cfg.warmup_steps, 1.0)
    return cfg.lr * warm


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree.values()))


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], opt_state: Dict[str, Any],
                  cfg: OptConfig
                  ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any],
                             Dict[str, torch.Tensor]]:
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    # A tensor numerator: ``float / tensor`` is a reciprocal times the
    # float in torch, not the division.
    clip = torch.tensor(cfg.grad_clip, dtype=F32, device=gnorm.device)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = _schedule(cfg, opt_state["step"])
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)
    mdt = moment_dtype(cfg)
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g32 = grads[name].to(F32) * scale
        m32 = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(F32) + (1 - cfg.b2) * g32 * g32
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if decays(name, p):                   # decoupled wd
            u = u + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * u).to(p.dtype))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
