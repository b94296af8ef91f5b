"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free Mamba-1,
ssm_state=16, vocab=65024.  [arXiv:2410.05355]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024,
    layer_pattern=("mamba1",), ssm_state=16, ssm_conv=4, d_inner=8192,
    tie_embeddings=True,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, d_inner=128, vocab=256,
        ssm_state=4, dt_rank=8)
