"""zamba2-2.7b [hybrid]: 54L d_model=2560 Mamba-2 backbone (ssm_state=64)
+ ONE weight-shared attention block (32H, kv=32) invoked every 6 layers on
concat[h, x_embed].  [arXiv:2411.15242]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    layer_pattern=("mamba2",) * 5 + ("mamba2+shared_attn",),
    ssm_state=64, ssm_head_dim=64, d_inner=5120,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16, d_inner=128)
