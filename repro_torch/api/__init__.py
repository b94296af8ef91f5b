"""The port's user-facing API: ``KMedoids``, its solver, metric and
stats-backend registries, and out-of-sample inference.  ``__all__`` holds
every name of the JAX package's ``repro.api.__all__`` but
``PALLAS_METRICS`` (``tests/test_torch_banditpam.py`` lists it with its
reason)."""

from ..core.distances import (attach_index, available_metrics,
                              register_metric, resolve_metric)
from ..core.engine import (available_stats_backends, get_stats_backend,
                           register_stats_backend, resolve_stats_backend)
from ..core.report import BatchFitReport, FitReport
from .estimator import KMedoids
from .predict import (assign_medoids, get_predict_fn, medoid_distances,
                      resolve_backend)
from .registry import (available_batch_solvers, available_solvers,
                       default_params, get_batch_solver, get_solver,
                       register_solver, solver_accepts_backend)

__all__ = ["BatchFitReport", "FitReport", "KMedoids", "assign_medoids",
           "attach_index", "available_batch_solvers", "available_metrics",
           "available_solvers", "available_stats_backends", "default_params",
           "get_batch_solver", "get_predict_fn", "get_solver",
           "get_stats_backend", "medoid_distances", "register_metric",
           "register_solver", "register_stats_backend", "resolve_backend",
           "resolve_metric", "resolve_stats_backend",
           "solver_accepts_backend"]
