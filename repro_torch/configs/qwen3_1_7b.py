"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8, head_dim 128)
d_ff=6144 vocab=151936, qk-norm.  [hf:Qwen/Qwen3-1.7B]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=6144, vocab=151936, head_dim=128,
    layer_pattern=("global",), qk_norm=True, rope_theta=1_000_000.0,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
