"""Architecture + input-shape configuration (the port's copy of
``repro.configs.base``: plain data, kept here so the port imports nothing
of the JAX package).

Every architecture has one module defining ``CONFIG`` with the exact
published numbers, plus ``reduced()`` — a same-family shrink for CPU
tests.  ``SHAPES`` defines the four input-shape cells; the helpers below
say which (arch x shape) cells are runnable (long_500k requires
sub-quadratic attention state).  ``get_config`` resolves inside
``repro_torch.configs``.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- attention pattern: repeating unit of layer kinds ---
    #   "global" | "local" (sliding window) | "chunked" (llama4 iRoPE) |
    #   "mamba1" | "mamba2" | "mamba2+shared_attn"
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 1024
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False      # arctic: dense MLP in parallel
    shared_expert: bool = False           # llama4: always-on shared expert
    capacity_factor: float = 1.25
    # --- SSM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: Optional[int] = None         # default 2*d_model
    dt_rank: Optional[int] = None         # default d_model//16 (mamba1)
    ssm_head_dim: int = 64                # mamba2
    # --- frontend stubs ---
    frontend: str = "none"                # none | vision_stub | audio_stub
    n_patches: int = 576                  # vision_stub prefix length
    n_codebooks: int = 4                  # audio_stub codebooks
    # --- training knobs ---
    moment_dtype: str = "float32"         # "bfloat16" for the 480B config
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def di(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    def pattern_for_all_layers(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.n_layers]

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.layer_pattern) == 0, self.name
        return self.n_layers // len(self.layer_pattern)

    def param_count(self) -> Dict[str, float]:
        """Analytic parameter counts (total & active) for MODEL_FLOPS."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.frontend == "audio_stub":
            emb = self.n_codebooks * v * d + self.n_codebooks * v * d
        per_attn = d * (self.n_heads * self.hd) + 2 * d * (self.n_kv_heads * self.hd) \
            + (self.n_heads * self.hd) * d
        per_mlp = 3 * d * ff
        total = active = emb
        for kind in self.pattern_for_all_layers():
            if kind.startswith("mamba"):
                di, st = self.di, self.ssm_state
                if kind.startswith("mamba2"):
                    nh = di // self.ssm_head_dim
                    # mamba2: in_proj d->(2*di + 2*st + nh), conv, out_proj
                    m = d * (2 * di + 2 * st + nh) + di * d + 3 * di
                else:
                    m = d * 2 * di + di * (self.dtr + 2 * st) + self.dtr * di \
                        + di * st + di * d + self.ssm_conv * di
                total += m
                active += m                 # a shared block: counted below
            else:
                total += per_attn
                active += per_attn
                if self.n_experts > 0:
                    total += self.n_experts * per_mlp + d * self.n_experts
                    active += self.top_k * per_mlp + d * self.n_experts
                    if self.moe_dense_residual or self.shared_expert:
                        total += per_mlp
                        active += per_mlp
                else:
                    total += per_mlp
                    active += per_mlp
        if any("shared_attn" in k for k in self.pattern_for_all_layers()):
            total += per_attn + per_mlp + 2 * d * d     # one shared block + concat proj
            n_calls = sum("shared_attn" in k for k in self.pattern_for_all_layers())
            active += n_calls * (per_attn + per_mlp + 2 * d * d)
        return {"total": float(total), "active": float(active)}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode
    microbatches: int = 1


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", microbatches=4),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "falcon_mamba_7b", "arctic_480b", "llama4_scout_17b", "gemma3_12b",
    "mistral_nemo_12b", "granite_8b", "qwen3_1_7b", "phi3_vision_4_2b",
    "zamba2_2_7b", "musicgen_large",
)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"{__package__}.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"{__package__}.{arch_id.replace('-', '_')}")
    return mod.reduced()


def supports_long_context(cfg: ArchConfig) -> bool:
    """long_500k runs only for archs whose state is sub-quadratic
    (SSM / hybrid / windowed-or-chunked attention)."""
    # pure full-attention stacks are excluded
    return set(cfg.pattern_for_all_layers()) != {"global"}


def cells(arch_id: str):
    """The runnable shape cells for an arch, each with its verdict."""
    cfg = get_config(arch_id)
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not supports_long_context(cfg):
            out.append((s.name, "skipped (pure full attention)"))
        else:
            out.append((s.name, "run"))
    return out


def reduce_cfg(cfg: ArchConfig, **overrides) -> ArchConfig:
    return dataclasses.replace(cfg, **overrides)
