"""repro_torch — the PyTorch/CUDA port of the BanditPAM system.

The JAX package ``repro`` (under ``src/``) is the reference; this
package mirrors its layout (``core/``, ``kernels/``, ``api/``,
``serve/``, ``runtime/``) and runs
on an NVIDIA H100 through hand-written CUDA kernels for ``sm_90a``.
Entry points take ``device=None`` (the card) and raise without one;
``device="cpu"`` runs the plain PyTorch versions.

This package imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``.
"""

__version__ = "0.1.0"
