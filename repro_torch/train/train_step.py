"""Loss and train-step factory (``repro.train.train_step``' counterpart):
next-token cross-entropy in float32, microbatched gradient accumulation
(the mean of the microbatch gradients), the layer groups recomputed in
the backward pass (inside the model).

The step is ``train_step(model, opt_state, batch) -> (model, opt_state,
metrics)``: the gradients are ``torch.autograd.grad`` of the loss with
respect to the model's parameters (the JAX step's ``jax.grad`` over the
same plain tensor ops; nothing of this path reaches a hand-written
kernel), and ``apply_updates`` writes the new parameters into the
model's tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import like, shard
from ..models.model import Decoder, params_of
from .optimizer import OptConfig, apply_updates

F32 = torch.float32
AUX_WEIGHT = 0.01


def lm_loss(cfg: ArchConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE in f32; audio: mean over codebooks ([..., nc, V])."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    # The label's logit as a masked sum over the vocabulary (every other
    # term an exact zero, so the same bits as a gather): on a mesh the
    # vocabulary is sharded and the sum reduces over it, where DTensor's
    # gather along a sharded dim fails.
    vocab = like(torch.arange(logits.shape[-1], device=labels.device), labels)
    gold = torch.where(labels[..., None] == vocab, logits, 0.0).sum(-1)
    nll = logz - gold
    if cfg.frontend == "audio_stub":
        nll = nll.mean(-1)                         # [B, L, nc] -> [B, L]
    mask = mask.to(F32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(cfg: ArchConfig, model: Decoder, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model(batch)
    ce = lm_loss(cfg, logits, batch["labels"], batch["loss_mask"])
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(cfg: ArchConfig, model: Decoder, batch):
    """``((loss, aux), grads)`` with ``grads`` keyed as ``params_of``."""
    params = params_of(model)
    with torch.enable_grad():
        loss, aux = loss_fn(cfg, model, batch)
        gs = torch.autograd.grad(loss, list(params.values()))
    return ((loss.detach(), {k: a.detach() for k, a in aux.items()}),
            dict(zip(params, gs)))


def _split_mb(batch: Mapping[str, torch.Tensor], microbatches: int):
    """The microbatches: consecutive rows, sliced (the rows of the JAX
    ``reshape(M, B/M, ...)``).  On a mesh each is sharded over the data
    axes again, as the model's input constraint places the JAX scan's
    microbatch (a reshape of a batch sharded over two mesh axes would
    leave a strided sharding, whose redistribution DTensor plans by a
    search that does not finish on a three-axis mesh)."""
    out = []
    for i in range(microbatches):
        mb = {}
        for k, x in batch.items():
            b = x.shape[0]
            assert b % microbatches == 0, (b, microbatches)
            n = b // microbatches
            mb[k] = shard(x[i * n:(i + 1) * n], "batch",
                          *([None] * (x.ndim - 1)))
        out.append(mb)
    return out


def accumulate_grads(cfg: ArchConfig, model: Decoder, batch,
                     microbatches: int = 1):
    """``(loss, aux, grads)`` over ``batch``: with several microbatches
    the float32 sum of their gradients in order, divided by their count
    (the JAX step's scan), and the mean loss."""
    if microbatches == 1:
        (loss, aux), grads = value_and_grad(cfg, model, batch)
        return loss, aux, grads
    g_sum = {n: torch.zeros_like(p, dtype=F32)
             for n, p in params_of(model).items()}
    l_sum = None
    for mb in _split_mb(batch, microbatches):
        (l, _), g = value_and_grad(cfg, model, mb)
        g_sum = {n: g_sum[n] + g[n] for n in g_sum}
        if l_sum is None:
            l_sum = like(torch.zeros((), dtype=F32, device=l.device), l)
        l_sum = l_sum + l
    loss = l_sum / microbatches
    return (loss, {"ce": loss, "aux": torch.zeros_like(loss)},
            {n: g / microbatches for n, g in g_sum.items()})


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    microbatches: int = 1):
    """Build the train step with gradient accumulation."""

    def train_step(model: Decoder, opt_state, batch):
        loss, aux, grads = accumulate_grads(cfg, model, batch, microbatches)
        _, opt_state, om = apply_updates(params_of(model), grads, opt_state,
                                         opt_cfg)
        metrics = {"loss": loss, **aux, **om}
        return model, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig):
    def eval_step(model: Decoder, batch):
        with torch.no_grad():
            loss, aux = loss_fn(cfg, model, batch)
        return {"loss": loss, **aux}
    return eval_step
