"""repro_torch — the PyTorch/CUDA port of the BanditPAM system.

The JAX package ``repro`` (under ``src/``) is the reference; this
package mirrors its layout and runs on an NVIDIA H100 through
hand-written CUDA kernels for ``sm_90a``:

* ``core/`` — distances, the stats-backend engine, the bandit search, the
  BanditPAM fit, its batch and its sharded fit, PAM, the baselines;
* ``kernels/`` — the CUDA kernels, their plain versions and wrappers;
* ``api/`` — the ``KMedoids`` facade and predict;
* ``serve/`` — ``MedoidService``, the reservoir, the drift monitor;
* ``runtime/`` — checkpoints and the fault-tolerant training loop;
* ``analysis/`` — the runtime guard and the peak-memory budgets;
* ``configs/``, ``models/``, ``train/`` — the LM data-curation path: the
  architectures, the decoder (dense, MoE, Mamba-1, Mamba-2 and zamba2's
  shared block), the data, AdamW, the train step and
  the curation driver (``python -m repro_torch.train.curated``);
* ``serve/lm.py``, ``launch/`` — LM serving: prefill and KV-cache decode
  (``python -m repro_torch.launch.serve``);
* ``convert.py`` — draws, fitted state, LM weights and decode state from
  the JAX package, given as numpy.

Entry points take ``device=None`` (the card) and raise without one;
``device="cpu"`` runs the plain PyTorch versions.

This package imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``.
"""

__version__ = "0.1.0"
