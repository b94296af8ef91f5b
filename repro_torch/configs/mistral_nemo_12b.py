"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8, head_dim 128)
d_ff=14336 vocab=131072, 128k ctx full attention.
[hf:mistralai/Mistral-Nemo-Base-2407]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
    layer_pattern=("global",), rope_theta=1_000_000.0,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
