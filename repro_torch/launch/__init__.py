"""Drivers (``repro.launch``' counterpart): ``serve``, batched prefill and
greedy decode of the dense LM (``python -m repro_torch.launch.serve``).
The rest of the JAX package's ``launch/`` (mesh, specs, dryrun, train)
is ROADMAP A17f."""
