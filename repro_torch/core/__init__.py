"""The port's core: distances, the stats-backend engine, the adaptive
search, the BanditPAM fit, its batched multi-fit and its sharded fit on
``torch.distributed``, exact PAM, the baselines, OneBatchPAM, the
random-draw seam with its threefry and the reports.  ``__all__`` holds every name of the JAX package's
``repro.core.__all__`` (``tests/test_torch_banditpam.py``)."""

from . import datasets, rng, threefry
from .adaptive import SearchResult, adaptive_search
from .banditpam import BanditPAM, FitResult
from .baselines import (BaselineResult, clara, clarans, fasterpam,
                        voronoi_iteration)
from .distributed import DistributedBanditPAM, MedoidCurator, default_group
from .distances import (attach_index, available_metrics, get_metric,
                        pairwise, register_metric, resolve_metric)
from .engine import (FitContext, available_stats_backends, get_stats_backend,
                     medoid_cache, register_stats_backend,
                     resolve_stats_backend, total_loss)
from .onebatch import onebatchpam
from .pam import PAMResult, pam
from .report import BatchFitReport, FitReport

__all__ = ["BanditPAM", "BaselineResult", "BatchFitReport",
           "DistributedBanditPAM", "FitContext", "FitReport", "FitResult",
           "MedoidCurator", "PAMResult", "SearchResult",
           "adaptive_search", "attach_index", "available_metrics",
           "available_stats_backends", "clara", "clarans", "datasets",
           "default_group",
           "fasterpam", "get_metric", "get_stats_backend", "medoid_cache",
           "onebatchpam", "pairwise", "pam", "register_metric",
           "register_stats_backend", "resolve_metric",
           "resolve_stats_backend", "rng", "threefry", "total_loss",
           "voronoi_iteration"]
