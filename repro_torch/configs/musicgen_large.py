"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
decoder-only over EnCodec tokens, vocab=2048 x 4 codebooks; frontend STUB
(delay-pattern interleaving handled outside; input is [B, L, 4] codes).
[arXiv:2306.05284]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048, head_dim=64,
    layer_pattern=("global",), frontend="audio_stub", n_codebooks=4,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64, n_codebooks=2)
