"""The port's core: distances, the stats-backend engine, the adaptive
search, the BanditPAM fit, exact PAM, the baselines, OneBatchPAM, the
random-draw seam with its threefry and the report."""

from . import datasets, rng, threefry
from .banditpam import BanditPAM
from .baselines import clara, clarans, fasterpam, voronoi_iteration
from .distances import available_metrics, get_metric, register_metric
from .engine import (available_stats_backends, get_stats_backend,
                     medoid_cache, register_stats_backend,
                     resolve_stats_backend, total_loss)
from .onebatch import onebatchpam
from .pam import pam
from .report import FitReport

__all__ = ["BanditPAM", "FitReport", "available_metrics",
           "available_stats_backends", "clara", "clarans", "datasets",
           "fasterpam", "get_metric", "get_stats_backend", "medoid_cache",
           "onebatchpam", "pam", "register_metric", "register_stats_backend",
           "resolve_stats_backend", "rng", "threefry", "total_loss",
           "voronoi_iteration"]
