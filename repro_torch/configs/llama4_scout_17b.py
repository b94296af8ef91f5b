"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert; 3:1 chunked-local
(iRoPE) : global attention, chunk 8192.  [hf:meta-llama/Llama-4-Scout-17B-16E]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    layer_pattern=("chunked", "chunked", "chunked", "global"), window=8192,
    n_experts=16, top_k=1, shared_expert=True, rope_theta=500_000.0,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=4, top_k=1, window=32)
