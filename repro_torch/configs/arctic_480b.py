"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]

bf16 AdamW moments: the JAX package's memory-fit choice for 479B params
(docs/design.md §Memory-fit), kept so the config equals its own."""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    layer_pattern=("global",), n_experts=128, top_k=2,
    moe_dense_residual=True, moment_dtype="bfloat16",
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=256, n_experts=4, top_k=2, moment_dtype="float32")
