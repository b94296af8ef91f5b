"""Deterministic, resumable synthetic LM data (``repro.train.data``'
counterpart).

Every batch is a pure function of ``(seed, step)``: the draws are the
JAX package's own, replayed by the port's threefry
(``repro_torch.core.threefry``), so a batch equals the JAX batch of the
same seed and step value for value.  That is what the fault-tolerant
loop's exact replay rests on: any process can recompute any step's
batch after a failure, and a checkpoint needs only the step counter.

Token streams follow a noisy affine recurrence, giving a learnable
structure (a model that captures the bigram dynamics drops well below
the uniform-entropy loss floor).  Tokens and labels are int64 (the
index type of ``F.embedding`` and ``gather``) holding the JAX int32
values.  An ``audio_stub`` batch keeps its ``[B, L, nc]`` codebook
streams; a ``vision_stub`` batch of length ``seq`` holds ``seq − P``
text tokens and ``patch_emb`` [B, P, d], float32 normal draws
(``threefry.normal``, jax's bits), with labels and loss mask zero over
the P patches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import threefry
from ..core.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    noise: float = 0.1         # fraction of uniformly-resampled tokens
    mult: int = 31             # affine recurrence multiplier


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, step: int,
                    dcfg: DataConfig = DataConfig(),
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Batch for `step`, identical no matter which process computes it."""
    dev = resolve_device(device)
    key = threefry.fold_in(threefry.PRNGKey(dcfg.seed), step)
    k1, k2, k3, k4 = threefry.split(key, 4)
    v = cfg.vocab
    nc = cfg.n_codebooks if cfg.frontend == "audio_stub" else 1
    x = threefry.randint(k1, (batch, nc), 0, v, device=dev)
    toks = [x]
    for _ in range(seq - 1):
        x = (x * dcfg.mult + 7) % v
        toks.append(x)
    toks = torch.stack(toks, dim=1)                      # [B, L, nc]
    # The float32 threshold: jax compares the float32 draws with it.
    noise_mask = threefry.uniform(k2, toks.shape, device=dev) < float(
        np.float32(dcfg.noise))
    toks = torch.where(noise_mask,
                       threefry.randint(k3, toks.shape, 0, v, device=dev),
                       toks)

    labels = torch.roll(toks, -1, dims=1)
    mask = torch.ones((batch, seq), dtype=torch.float32, device=dev)
    mask[:, -1] = 0.0

    if cfg.frontend == "audio_stub":
        return {"tokens": toks, "labels": labels, "loss_mask": mask}
    toks, labels = toks[..., 0], labels[..., 0]
    out = {"tokens": toks, "labels": labels, "loss_mask": mask}
    if cfg.frontend == "vision_stub":
        p = cfg.n_patches
        out["tokens"] = toks[:, :seq - p]
        out["patch_emb"] = threefry.normal(k4, (batch, p, cfg.d_model),
                                           device=dev)
        # labels cover the full (patch + text) sequence; no loss on patches
        out["labels"] = torch.cat(
            [torch.zeros((batch, p), dtype=labels.dtype, device=dev),
             labels[:, :seq - p]], dim=1)
        out["loss_mask"] = torch.cat(
            [torch.zeros((batch, p), dtype=torch.float32, device=dev),
             mask[:, :seq - p]], dim=1)
    return out


class DataPipeline:
    """Stateful iterator facade over the stateless generator (checkpoints
    store just `step`)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int,
                 dcfg: DataConfig = DataConfig(), start_step: int = 0,
                 device: DeviceLike = None):
        self.cfg, self.batch, self.seq, self.dcfg = cfg, batch, seq, dcfg
        self.device = resolve_device(device)
        self.step = start_step

    def __next__(self):
        b = synthetic_batch(self.cfg, self.batch, self.seq, self.step,
                            self.dcfg, self.device)
        self.step += 1
        return b

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.dcfg.seed}

    @classmethod
    def from_state(cls, cfg, batch, seq, state: Dict,
                   device: DeviceLike = None) -> "DataPipeline":
        return cls(cfg, batch, seq, DataConfig(seed=state["seed"]),
                   start_step=state["step"], device=device)
