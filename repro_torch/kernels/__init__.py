"""The port's hand-written CUDA kernels (``csrc/``), their plain PyTorch
versions, launch counters and public wrappers (``ops``).  Nothing is
compiled at import: ``build.lib()`` builds the library at first use."""
