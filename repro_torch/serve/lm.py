"""LM serving steps (counterpart of ``repro.serve.lm``): prefill (prompt
-> caches + last logits) and single-token decode against the caches,
both under ``torch.no_grad()``, and a greedy loop.

The loop keeps its tokens and the position on the model's device: a
step reads nothing back, so the card runs ahead of the host.  This
module is the language-model side of ``repro_torch.serve`` and stays out
of the package's ``__all__``, as the JAX module stays out of
``repro.serve``'s: import ``repro_torch.serve.lm`` explicitly.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..models import model as M


def make_prefill_step(cfg: ArchConfig, cache_len: Optional[int] = None):
    """``prefill(model, batch) -> (logits [B, 1, V], state)``: the last
    position's logits (audio [B, 1, nc, V]) and the caches of
    ``cache_len`` positions (the prompt's length, a vision batch's
    ``patch_emb`` included, when None)."""
    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _, state = model(batch, collect_state=True,
                                 cache_len=cache_len)
        return logits[:, -1:], state
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode(model, state, batch, pos) -> (logits [B, 1, V], state)``
    (``models.model.decode_step``)."""
    @torch.no_grad()
    def decode_step(model, state, batch, pos):
        return M.decode_step(cfg, model, state, batch, pos)
    return decode_step


def greedy_decode(cfg: ArchConfig, model, state, first_token: torch.Tensor,
                  start_pos: int, n_tokens: int):
    """``n_tokens`` greedy steps from ``first_token`` [B, 1] at absolute
    position ``start_pos``; returns (tokens [B, n_tokens] int32, state)
    on the model's device.  Audio takes the argmax of each codebook:
    ``first_token`` [B, 1, nc], tokens [B, n_tokens, nc]."""
    step = make_decode_step(cfg)
    tok = first_token
    pos = torch.full((), start_pos, dtype=torch.int64,
                     device=first_token.device)
    out = []
    for _ in range(n_tokens):
        logits, state = step(model, state, {"tokens": tok}, pos)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1), state
