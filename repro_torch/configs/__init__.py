"""The model configurations (``repro.configs``' counterpart, a copy of
its plain data): ``ArchConfig``, ``ShapeConfig``, the ten architectures
of ``ARCH_IDS`` with their published widths and ``reduced()`` shrinks,
and ``get_config`` / ``get_reduced``, which resolve inside this
package."""

from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, cells,
                   get_config, get_reduced, supports_long_context)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "cells",
           "get_config", "get_reduced", "supports_long_context"]
