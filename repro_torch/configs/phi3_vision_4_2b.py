"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend STUB (input_specs provides
precomputed patch embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96,
    layer_pattern=("global",), frontend="vision_stub", n_patches=576,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_patches=8)
