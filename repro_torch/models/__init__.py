"""The LM substrate's model (``repro.models``' counterpart): the decoder
(``model``) on its building blocks: attention and the MLP (``layers``),
the MoE layer (``moe``) and the Mamba-1 / Mamba-2 blocks (``ssm``)."""

from . import layers, model, moe, ssm

__all__ = ["layers", "model", "moe", "ssm"]
