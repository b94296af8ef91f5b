"""The port's core: distances, the stats-backend engine, the adaptive
search, the BanditPAM fit, exact PAM, the random-draw seam and the
report."""

from . import datasets, rng
from .banditpam import BanditPAM
from .distances import available_metrics, get_metric, register_metric
from .engine import (available_stats_backends, get_stats_backend,
                     medoid_cache, register_stats_backend,
                     resolve_stats_backend, total_loss)
from .pam import pam
from .report import FitReport

__all__ = ["BanditPAM", "FitReport", "available_metrics",
           "available_stats_backends", "datasets", "get_metric",
           "get_stats_backend", "medoid_cache", "pam", "register_metric",
           "register_stats_backend", "resolve_stats_backend", "rng",
           "total_loss"]
