"""Drivers (``repro.launch``' counterpart): ``serve`` (batched prefill
and greedy decode, ``python -m repro_torch.launch.serve``), ``train``
(the fault-tolerant training driver), ``dryrun`` (every cell on the
production meshes over a fake group), ``mesh`` (the production meshes)
and ``specs`` (meta-device stand-ins and the sharding of every cell's
tensors)."""
