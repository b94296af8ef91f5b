"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8, head_dim 256)
d_ff=15360 vocab=262144; 5:1 local(1024-window):global, qk-norm, 128k ctx.
[hf:google/gemma-3-12b-pt]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_ff=15360, vocab=262144, head_dim=256,
    layer_pattern=("local",) * 5 + ("global",), window=1024, qk_norm=True,
    rope_theta=1_000_000.0,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=16)
