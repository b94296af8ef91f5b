"""The LM substrate's model (``repro.models``' counterpart): the dense
decoder (``model``) on its building blocks (``layers``).  MoE (``moe``)
and the SSM layers (``ssm``) are ROADMAP A17c and A17d."""

from . import layers, model

__all__ = ["layers", "model"]
