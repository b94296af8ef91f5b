"""``KMedoids`` — the scikit-learn-style facade (counterpart of
``repro.api.KMedoids``)::

    from repro_torch.api import KMedoids

    est = KMedoids(k=5, solver="banditpam", metric="l2", seed=0)  # on the card
    est.fit(X)                      # X: [n, d] numpy or tensor
    est.medoids_, est.labels_, est.loss_, est.report_
    est.predict(X_new)              # [m] nearest-medoid labels
    est.transform(X_new)            # [m, k] dissimilarities
    batch = est.fit_batch([X0, X1, ...], seeds=[...])  # many fits at once

``device=None`` means the card and raises without one; ``device="cpu"``
runs the plain PyTorch path.  ``labels_`` come from one top-2 pass (the
``top2`` kernel on the card); ``transform`` from the pairwise path (the
``pairwise`` kernel) and ``predict`` is its first-index argmin.

``metric`` is a registered name, a raw ``[m, d] x [r, d] -> [m, r]``
callable of tensors (registered on first use), or ``"precomputed"``:
then ``fit`` takes the ``[n, n]`` dissimilarity matrix itself, and
``predict`` / ``transform`` take the ``[m, n]`` query-to-fit-points
block, whose medoid columns are the answer.

``fit_batch`` fits many independent datasets in one call (the bandit
solvers; ``core/batch.py``) and returns a ``BatchFitReport`` with
``[B, n_max]`` labels from one lane ``top2`` launch; it does not set the
single-fit state.

``KMedoids.from_fitted(X, medoids, metric)`` builds a fitted estimator
from given medoid indices, e.g. medoids fitted by the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.distances import attach_index, resolve_metric
from ..core.batch import lane_arrays
from ..core.engine import (LaneData, get_stats_backend, host_stage,
                           medoid_cache, resolve_stats_backend)
from .predict import DEFAULT_CHUNK, medoid_distances_t
from .registry import get_batch_solver, get_solver, solver_accepts_backend


def _pad_batch(X_batch, dev: torch.device) -> LaneData:
    """A ``[B, n, d]`` array or a (ragged) list of ``[n_i, d]`` arrays as
    one padded lane tensor on ``dev`` (zero pad rows)."""
    with host_stage("the batch's data"):
        return LaneData.pad([a.to(dev) for a in lane_arrays(X_batch)], dev)


def _batch_labels(lanes: LaneData, medoids: np.ndarray, metric: str,
                  backend: str) -> np.ndarray:
    """In-sample labels of a batch of fits, ``[B, n_max]`` int32: one lane
    ``top2`` pass (the lane kernel on the card), each lane's the single
    facade's; 0 past a fit's n."""
    dev = lanes.data.device
    with host_stage("the batch's medoids"):
        med = torch.as_tensor(np.asarray(medoids, np.int64)).to(dev)
    _, _, assign = get_stats_backend(backend).top2_lanes(lanes, med,
                                                         metric=metric)
    labels = assign.cpu().numpy()[:, :max(lanes.ns)]
    for i, n in enumerate(lanes.ns):
        labels[i, n:] = 0
    return labels


class KMedoids:
    """k-medoids clustering through the solver registry.

    Args:
      k: number of medoids.
      solver: registered solver name (``available_solvers()``).
      metric: a registered name (``"l2"``, ``"l2sq"``, ``"l1"``,
        ``"cosine"``, ...), a callable, or ``"precomputed"``.
      seed: forwarded to the stochastic solvers; the bandit solvers draw
        the JAX package's threefry chain for it, so a seed gives the JAX
        fit.
      backend: stats backend of the fit (``"auto"``, ``"cuda"``,
        ``"torch"``).
      predict_backend: backend of ``predict``/``transform``.
      predict_chunk: query rows per pairwise call in predict/transform.
      device: ``None`` (the card), ``"cuda"`` or ``"cpu"``.
      **solver_params: passed to the solver.
    """

    def __init__(self, k: int, solver: str = "banditpam", metric="l2",
                 seed: int = 0, backend: str = "auto",
                 predict_backend: str = "auto",
                 predict_chunk: int = DEFAULT_CHUNK,
                 device: DeviceLike = None, **solver_params):
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.solver = solver
        self.metric = metric
        self.seed = int(seed)
        self.backend = backend
        self.predict_backend = predict_backend
        self.predict_chunk = int(predict_chunk)
        self.device = device
        self.solver_params = dict(solver_params)
        self.report_ = None
        self.medoids_ = None
        self.labels_ = None
        self.loss_ = None

    def __repr__(self):
        extra = "".join(f", {k}={v!r}" for k, v in self.solver_params.items())
        return (f"KMedoids(k={self.k}, solver={self.solver!r}, "
                f"metric={self.metric!r}, seed={self.seed}{extra})")

    def _data(self, X, dev: torch.device) -> torch.Tensor:
        with host_stage("the data"):
            data = torch.as_tensor(X, dtype=torch.float32).to(
                dev).contiguous()
        if data.ndim != 2:
            raise ValueError(f"expected [n, d] data, got shape "
                             f"{tuple(data.shape)}")
        return data

    def _fit_data(self, X, metric_name: str,
                  dev: torch.device) -> torch.Tensor:
        """``X`` on the device; for ``"precomputed"`` the ``[n, n]``
        matrix with its index column (``attach_index``)."""
        data = self._data(X, dev)
        return attach_index(data) if metric_name == "precomputed" else data

    def _set_fitted(self, data: torch.Tensor, medoids: np.ndarray,
                    metric_name: str) -> None:
        dev = data.device
        with host_stage("the fitted medoids"):
            med_t = torch.as_tensor(medoids, dtype=torch.int64, device=dev)
        # In-sample labels (and the loss) under the fit's metric (for
        # "precomputed", the lookup over the indexed matrix): one top-2
        # pass.
        d1, _, assign = medoid_cache(
            data, med_t, metric=metric_name,
            backend=resolve_stats_backend(self.backend, metric_name, dev))
        self.loss_ = float(torch.sum(d1))
        self.medoids_ = medoids
        self.labels_ = assign.cpu().numpy()
        self._metric_name = metric_name
        if metric_name == "precomputed":
            # Queries are [m, n_fit] blocks; the medoids are columns.
            self._n_fit = data.shape[0]
            self._medoid_points = None
            self._medoid_cols = med_t
            self.n_features_in_ = data.shape[0]
        else:
            self._medoid_points = data[med_t].contiguous()
            self.n_features_in_ = data.shape[1]

    # -- fitting ---------------------------------------------------------
    def fit(self, X, layouts=None) -> "KMedoids":
        """Fit on ``X``; ``layouts`` (``repro_torch.core.rng``) replaces
        the default permutation source, e.g. with the JAX chain's."""
        solver_fn = get_solver(self.solver)
        metric_name = resolve_metric(self.metric)
        dev = resolve_device(self.device)
        data = self._fit_data(X, metric_name, dev)
        if data.shape[0] <= self.k:
            raise ValueError(f"need n > k, got n={data.shape[0]}, k={self.k}")
        params = dict(self.solver_params)
        if solver_accepts_backend(self.solver):
            params.setdefault("backend", self.backend)
        elif self.backend != "auto":
            raise ValueError(f"solver {self.solver!r} does not take a stats "
                             f"backend")
        report = solver_fn(data, self.k, metric=metric_name, seed=self.seed,
                           device=dev, layouts=layouts, **params)
        medoids = np.asarray(report.medoids).astype(np.int64)
        self._set_fitted(data, medoids, metric_name)
        report.labels = self.labels_
        report.solver = self.solver
        report.metric = metric_name
        self.report_ = report
        self.loss_ = float(report.loss)
        return self

    def fit_batch(self, X_batch, seeds=None):
        """Fit a batch of INDEPENDENT datasets: ``X_batch`` a ``[B, n, d]``
        array or a list of ``[n_i, d]`` arrays, ``seeds`` the per-fit
        seeds (default: ``self.seed`` for every fit).  Only the solvers
        with a batched entry point (``available_batch_solvers()``: the
        bandit solvers); each fit equals the single fit with its seed.

        Returns a :class:`~repro_torch.core.report.BatchFitReport` with
        ``labels`` ``[B, n_max]`` (0 past a fit's n).  Does NOT set the
        single-fit state (``medoids_`` etc.): a batch has no single
        in-sample assignment for ``predict``."""
        batch_fn = get_batch_solver(self.solver)   # fail fast on bad names
        metric_name = resolve_metric(self.metric)
        if metric_name == "precomputed":
            raise ValueError("fit_batch does not support "
                             "metric='precomputed' (per-fit dissimilarity "
                             "matrices would be ragged); pass features")
        params = dict(self.solver_params)
        if solver_accepts_backend(self.solver):
            params.setdefault("backend", self.backend)
        dev = resolve_device(self.device)
        report = batch_fn(X_batch, self.k, metric=metric_name,
                          seed=self.seed, device=dev, seeds=seeds, **params)
        lanes = _pad_batch(X_batch, dev)
        report.labels = _batch_labels(
            lanes, report.medoids, metric_name,
            resolve_stats_backend(params.get("backend", self.backend),
                                  metric_name, dev))
        report.solver = self.solver
        report.metric = metric_name
        return report

    @classmethod
    def from_fitted(cls, X, medoids, metric: str = "l2", *,
                    device: DeviceLike = None, **kw) -> "KMedoids":
        """A fitted estimator for given medoid indices into ``X``;
        ``loss_`` is their total nearest-medoid dissimilarity."""
        medoids = np.asarray(medoids, np.int64).ravel()
        est = cls(k=medoids.shape[0], metric=metric, device=device, **kw)
        metric_name = resolve_metric(metric)
        dev = resolve_device(device)
        est._set_fitted(est._fit_data(X, metric_name, dev), medoids,
                        metric_name)
        return est

    def _check_fitted(self):
        if self.medoids_ is None:
            raise ValueError("this KMedoids instance is not fitted yet; "
                             "call fit(X) first")

    # -- inference -------------------------------------------------------
    def _transform_t(self, X, backend: Optional[str]) -> torch.Tensor:
        self._check_fitted()
        if self._metric_name == "precomputed":
            q = self._data(X, self._medoid_cols.device)
            if q.shape[1] != self._n_fit:
                raise ValueError(
                    f"precomputed queries must be [m, n_fit={self._n_fit}] "
                    f"dissimilarities to the fit points, got "
                    f"{tuple(q.shape)}")
            return q.index_select(1, self._medoid_cols)
        if len(X.shape) != 2 or X.shape[1] != self.n_features_in_:
            raise ValueError(f"queries must be [m, {self.n_features_in_}], "
                             f"got shape {tuple(X.shape)}")
        return medoid_distances_t(
            X, self._medoid_points, self._metric_name,
            backend=self.predict_backend if backend is None else backend,
            chunk=self.predict_chunk)

    def transform(self, X, backend: Optional[str] = None) -> np.ndarray:
        """Dissimilarities from each query row to the medoids, [m, k];
        with ``metric="precomputed"``, ``X`` is the ``[m, n_fit]``
        query-to-fit-points block."""
        return self._transform_t(X, backend).cpu().numpy()

    def predict(self, X, backend: Optional[str] = None) -> np.ndarray:
        """Nearest-medoid label (0..k-1) per query row; ties go to the
        lowest index."""
        return torch.argmin(self._transform_t(X, backend),
                            dim=1).cpu().numpy()

    def fit_predict(self, X, layouts=None) -> np.ndarray:
        return self.fit(X, layouts=layouts).labels_

    def fit_transform(self, X, layouts=None) -> np.ndarray:
        return self.fit(X, layouts=layouts).transform(X)
