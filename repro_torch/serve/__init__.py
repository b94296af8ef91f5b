"""``repro_torch.serve``: the streaming k-medoids serving layer
(counterpart of ``repro.serve``): :class:`MedoidService` (medoids on the
device, a CLARA-style weighted reservoir, drift-triggered warm-start
refits, bit-identical snapshot and resume) and its building blocks."""

from .drift import DriftMonitor
from .reservoir import Reservoir
from .service import IngestResult, MedoidService

__all__ = ["DriftMonitor", "IngestResult", "MedoidService", "Reservoir"]
