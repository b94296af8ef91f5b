"""The port's user-facing API: ``KMedoids`` and out-of-sample inference."""

from .estimator import KMedoids
from .predict import assign_medoids, medoid_distances
from .registry import (available_solvers, default_params, get_solver,
                       register_solver)

__all__ = ["KMedoids", "assign_medoids", "available_solvers",
           "default_params", "get_solver", "medoid_distances",
           "register_solver"]
