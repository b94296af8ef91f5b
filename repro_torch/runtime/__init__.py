"""The port's runtime support: checkpoint save and restore
(:mod:`.checkpoint`, used by the serving layer and the LM loop) and the
fault-tolerant training loop (:mod:`.fault`, imported explicitly, as the
JAX package's ``repro.runtime.fault`` is), and elastic re-meshing
(:mod:`.elastic`, imported explicitly too)."""
