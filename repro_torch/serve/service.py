"""MedoidService — the streaming k-medoids serving layer (counterpart of
``repro.serve.service``).

One service owns:

* **medoids on the device**, a ``[k, d]`` tensor that every request is
  scored against through ``repro_torch.api.predict`` (the ``top2`` kernel
  on the card for labels and nearest distances, ``pairwise`` for
  ``transform``).  PyTorch runs eagerly: a request is one upload, one
  launch and one read of labels and distances together;
* **a CLARA-style weighted reservoir** (:class:`~repro_torch.serve.
  reservoir.Reservoir`): ingested points survive with probability
  proportional to their weight (by default their assignment loss, so
  badly served points are over-represented in the next refit sample);
* **a drift monitor** (:class:`~repro_torch.serve.drift.DriftMonitor`):
  the mean ingest loss against the fitted baseline; past
  ``(1 + threshold)·mu0`` over at least ``window`` points, the service
  refits itself;
* **refits**: ``refit="warm"`` warm-starts BanditPAM's SWAP from the
  current medoids over the PIC ring (``BanditPAM.fit(..., warm_start=
  ...)``: BUILD is skipped, so the warm ledger pays fewer fresh
  evaluations than a cold fit of the same sample); ``refit="onebatch"``
  is OneBatchPAM seeded with the serving medoids (``init=``);
  ``refit="cold"`` is the full fit from scratch, the control.

Everything that decides the service's future behaviour (medoids,
reservoir contents and A-Res keys, stream position, which is the
position of every random draw, drift counters, the cumulative ledger)
snapshots through ``repro_torch.runtime.checkpoint`` and resumes bit for
bit: a restored service fed the same remaining stream trips the same
refits on the same points and lands on the same medoids.  The draws,
seeds and decisions are the JAX package's, so a port service fed the
JAX service's stream refits where it does
(``tests/test_torch_serve.py``), and ``repro_torch.convert.
service_from_reference`` carries a JAX service's state across.

``device=None`` runs on the card and raises without one; pass
``device="cpu"`` for the plain PyTorch path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.predict import DEFAULT_CHUNK, assign_medoids, medoid_distances
from ..api.registry import default_params, get_solver, solver_accepts_backend
from ..core.banditpam import BanditPAM
from ..core.device import DeviceLike, resolve_device
from ..core.distances import resolve_metric
from ..core.engine import host_stage
from ..core.onebatch import onebatchpam
from ..core.report import FitReport
from ..distributed.sharding import to_local_full
from ..runtime import checkpoint as ckpt
from .drift import DriftMonitor
from .reservoir import Reservoir

__all__ = ["MedoidService", "IngestResult"]

REFIT_MODES = ("warm", "onebatch", "cold")
RESERVOIR_WEIGHTS = ("loss", "uniform")

# Mixes the refit ordinal into the per-refit solver seed, so successive
# refits explore distinct SWAP chains while staying a function of
# (service seed, refit count): the snapshot/resume contract.
_REFIT_SEED_STRIDE = 1_000_003


@dataclass
class IngestResult:
    """What one ``ingest`` call did: assignments for the offered points
    and, if the drift monitor tripped, the refit's report."""
    labels: np.ndarray                     # [m] int32
    dmin: np.ndarray                       # [m] float32 nearest-medoid dist
    refit: Optional[FitReport] = None      # set when this call refitted
    drift_mean: float = 0.0                # monitor mean AFTER this chunk


@dataclass
class _Ledger:
    """Cumulative fresh/cached evaluation ledger across fit + refits."""
    fresh: int = 0
    cached: int = 0
    refits: List[Dict] = field(default_factory=list)

    def add(self, report: FitReport, kind: str, wall_s: float) -> None:
        led = report.ledger()
        self.fresh += int(led["fresh"])
        self.cached += int(led["cached"])
        self.refits.append({
            "kind": kind, "loss": float(report.loss),
            "fresh": int(led["fresh"]), "cached": int(led["cached"]),
            "n_swaps": int(report.n_swaps),
            "converged": bool(report.converged),
            "wall_s": float(wall_s)})


class MedoidService:
    """Online k-medoids: serve, ingest, refit on drift.

    Args:
      k: number of medoids.
      metric: a registered metric name (``"precomputed"`` is rejected:
        serving needs feature vectors it can score).
      solver: facade solver of the initial ``fit`` (registry name).
      solver_params: params of the initial fit (default:
        ``registry.default_params(solver)``).
      refit: ``"warm"`` | ``"onebatch"`` | ``"cold"``, the refit strategy.
      refit_params: extra params of the refit solver (e.g.
        ``{"cache_width": 16}`` for warm, ``{"ref_size": 512}`` for
        onebatch).
      reservoir_size: points held for refits (the CLARA sample bound).
      reservoir_weights: ``"loss"`` (assignment-loss weighted: the badly
        served survive) or ``"uniform"``.
      drift_threshold / drift_window: see :class:`DriftMonitor`.
      backend: stats backend of fit, refit and predict (``"auto"``: the
        kernels on the card, the plain versions on the CPU).
      request_chunk: query rows per pairwise call in ``transform``.
      seed: service seed: the reservoir's key chain and the refit seeds.
      device: ``None`` (the card), ``"cuda"`` or ``"cpu"``.
    """

    def __init__(self, k: int, metric: str = "l2", *,
                 solver: str = "banditpam_pp",
                 solver_params: Optional[dict] = None,
                 refit: str = "warm",
                 refit_params: Optional[dict] = None,
                 reservoir_size: int = 2048,
                 reservoir_weights: str = "loss",
                 drift_threshold: float = 0.25,
                 drift_window: int = 256,
                 backend: str = "auto",
                 request_chunk: int = DEFAULT_CHUNK,
                 seed: int = 0,
                 device: DeviceLike = None):
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        metric = resolve_metric(metric)
        if metric == "precomputed":
            raise ValueError("MedoidService requires feature vectors; "
                             "metric='precomputed' cannot score new points")
        if refit not in REFIT_MODES:
            raise ValueError(f"refit must be one of {REFIT_MODES}, "
                             f"got {refit!r}")
        if reservoir_weights not in RESERVOIR_WEIGHTS:
            raise ValueError(f"reservoir_weights must be one of "
                             f"{RESERVOIR_WEIGHTS}, got {reservoir_weights!r}")
        self.k = int(k)
        self.metric = metric
        self.solver = solver
        self.solver_params = (dict(solver_params) if solver_params is not None
                              else default_params(solver))
        self.refit_mode = refit
        self.refit_params = dict(refit_params or {})
        self.reservoir_size = int(reservoir_size)
        self.reservoir_weights = reservoir_weights
        self.drift_threshold = float(drift_threshold)
        self.drift_window = int(drift_window)
        self.backend = backend
        self.request_chunk = int(request_chunk)
        self.seed = int(seed)
        self.device = device
        # fitted state
        self.medoid_points: Optional[torch.Tensor] = None   # [k, d] device
        self.d: Optional[int] = None
        self.reservoir: Optional[Reservoir] = None
        self.drift = DriftMonitor(self.drift_threshold, self.drift_window)
        self.n_refits = 0
        self.ledger = _Ledger()
        self.last_report: Optional[FitReport] = None

    # -- fit -------------------------------------------------------------
    def fit(self, X) -> "MedoidService":
        """Initial offline fit; seeds the reservoir with the training
        points and arms the drift monitor at the fitted mean loss."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"expected [n, d] data, got {X.shape}")
        n = X.shape[0]
        if n <= self.k:
            raise ValueError(f"need n > k, got n={n}, k={self.k}")
        dev = resolve_device(self.device)
        self.d = int(X.shape[1])
        params = dict(self.solver_params)
        if solver_accepts_backend(self.solver):
            params.setdefault("backend", self.backend)
        with host_stage("the service's data"):
            data = torch.from_numpy(X).to(dev)
        t0 = time.perf_counter()
        report = get_solver(self.solver)(data, self.k, metric=self.metric,
                                         seed=self.seed, device=dev,
                                         **params)
        wall = time.perf_counter() - t0
        with host_stage("the fitted medoids"):
            med = torch.as_tensor(report.medoids).to(dev)
        self.medoid_points = data.index_select(0, med).contiguous()
        self.last_report = report
        self.ledger.add(report, "fit", wall)
        self.reservoir = Reservoir(self.reservoir_size, self.d,
                                   seed=self.seed)
        # The training points go through the stream's weighting.
        _, dmin = self._assign(data)
        self.reservoir.offer(X, self._weights(dmin))
        self.drift.reset(report.loss / n)
        return self

    # -- serve -----------------------------------------------------------
    def _require_fitted(self):
        if self.medoid_points is None:
            raise RuntimeError("MedoidService is not fitted; call fit() "
                               "or restore()")

    def _assign(self, X) -> Tuple[np.ndarray, np.ndarray]:
        return assign_medoids(X, self.medoid_points, self.metric,
                              backend=self.backend,
                              device=self.medoid_points.device)

    def predict(self, X) -> np.ndarray:
        """``[m, d]`` queries → ``[m]`` medoid labels (one ``top2`` pass,
        one read)."""
        self._require_fitted()
        return self._assign(np.asarray(X, np.float32))[0]

    def transform(self, X) -> np.ndarray:
        """``[m, d]`` queries → ``[m, k]`` distances to the medoids."""
        self._require_fitted()
        return medoid_distances(np.asarray(X, np.float32),
                                self.medoid_points, self.metric,
                                backend=self.backend,
                                chunk=self.request_chunk,
                                device=self.medoid_points.device)

    # -- ingest + drift --------------------------------------------------
    def _weights(self, dmin: np.ndarray) -> np.ndarray:
        if self.reservoir_weights == "uniform":
            return np.ones_like(dmin, np.float64)
        # Loss weighting: the eps floor keeps zero-distance duplicates
        # alive with a small (not zero) survival probability.
        d = np.asarray(dmin, np.float64)
        return d + 1e-6 * max(1.0, float(d.mean()) if d.size else 1.0)

    def ingest(self, X) -> IngestResult:
        """Score a stream chunk, fold it into the reservoir and the drift
        window, and refit if the monitor trips."""
        self._require_fitted()
        X = np.asarray(X, np.float32)
        labels, dmin = self._assign(X)
        self.reservoir.offer(X, self._weights(dmin))
        self.drift.update(dmin)
        refit_report = None
        if self.drift.drifted:
            refit_report = self._refit()
        return IngestResult(labels=labels, dmin=dmin, refit=refit_report,
                            drift_mean=self.drift.mean)

    # -- refit -----------------------------------------------------------
    def _refit_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """Refit sample: the current medoids (rows 0..k) and the
        reservoir's points.  Keeping the medoids in the candidate set
        makes the warm-start indices valid and lets a converged SWAP keep
        them."""
        med = self.medoid_points.cpu().numpy()
        data = np.concatenate([med, self.reservoir.points], axis=0)
        return data, np.arange(self.k, dtype=np.int64)

    def _refit_seed(self) -> int:
        return self.seed + _REFIT_SEED_STRIDE * (self.n_refits + 1)

    def refit_report_pair(self) -> Tuple[FitReport, FitReport]:
        """Run the configured warm refit and a cold control on the same
        sample and seed, changing no state: the ledger comparison."""
        self._require_fitted()
        data, warm_idx = self._refit_data()
        seed = self._refit_seed()
        return (self._run_refit(data, warm_idx, seed),
                self._run_refit(data, None, seed))

    def _run_refit(self, data: np.ndarray, warm_idx: Optional[np.ndarray],
                   seed: int) -> FitReport:
        dev = self.medoid_points.device
        if self.refit_mode == "onebatch":
            return onebatchpam(data, self.k, metric=self.metric, seed=seed,
                               backend=self.backend, init=warm_idx,
                               device=dev, **self.refit_params)
        params = dict(self.refit_params)
        params.setdefault("reuse", "pic")
        if params["reuse"] == "pic" and "cache_width" not in params:
            # Serving refits default to a half-coverage ring: wide enough
            # that the carried-moment repair serves real cached reads,
            # narrow enough that the ring keeps recycling (a fully
            # resident ring mostly subsidises the cold BUILD the warm
            # path exists to skip).
            B = int(params.get("batch_size", 100))
            n_rounds = -(-data.shape[0] // B)
            params["cache_width"] = max(1, n_rounds // 2) * B
        est = BanditPAM(self.k, metric=self.metric, seed=seed,
                        backend=self.backend, device=dev, **params)
        if self.refit_mode == "cold":
            warm_idx = None
        return est.fit(data, warm_start=warm_idx)

    def _refit(self) -> FitReport:
        data, warm_idx = self._refit_data()
        seed = self._refit_seed()
        t0 = time.perf_counter()
        report = self._run_refit(data, warm_idx, seed)
        wall = time.perf_counter() - t0
        self.n_refits += 1
        with host_stage("the refit's medoid points"):
            self.medoid_points = torch.from_numpy(
                data[np.asarray(report.medoids)]).to(
                    self.medoid_points.device)
        self.last_report = report
        self.ledger.add(report, f"refit:{self.refit_mode}", wall)
        self.drift.reset(report.loss / data.shape[0])
        return report

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict:
        """Host-side service counters (JSON-safe)."""
        return {"seen": int(self.reservoir.seen) if self.reservoir else 0,
                "reservoir_filled": len(self.reservoir)
                if self.reservoir else 0,
                "n_refits": int(self.n_refits),
                "fresh_evals": int(self.ledger.fresh),
                "cached_evals": int(self.ledger.cached),
                "drift_mean": self.drift.mean,
                "drift_count": int(self.drift.count),
                "baseline": float(self.drift.baseline)}

    # -- snapshot / resume ----------------------------------------------
    def _state_tree(self) -> Dict:
        """The full behavioural state as a checkpoint tree.  Device leaf:
        ``medoid_points``; everything else is host numpy (float64 /
        int64) and round-trips bit for bit."""
        return {"medoid_points": self.medoid_points,
                "reservoir": self.reservoir.state(),
                "drift": self.drift.state(),
                "counters": {"n_refits": np.int64(self.n_refits),
                             "fresh": np.int64(self.ledger.fresh),
                             "cached": np.int64(self.ledger.cached)}}

    def config(self) -> Dict:
        """The constructor's arguments (but ``device``) and ``d``: the
        JAX service's ``config()``."""
        return {"k": self.k, "metric": self.metric, "solver": self.solver,
                "solver_params": self.solver_params,
                "refit": self.refit_mode, "refit_params": self.refit_params,
                "reservoir_size": self.reservoir_size,
                "reservoir_weights": self.reservoir_weights,
                "drift_threshold": self.drift_threshold,
                "drift_window": self.drift_window,
                "backend": self.backend,
                "request_chunk": self.request_chunk,
                "seed": self.seed, "d": self.d}

    def snapshot(self, ckpt_dir: str, step: Optional[int] = None) -> str:
        """Write the service state under ``ckpt_dir`` (atomic publish).
        ``step`` defaults to the stream position, so successive snapshots
        never collide."""
        self._require_fitted()
        if step is None:
            step = int(self.reservoir.seen)
        extra = {"service": self.config(), "refits": self.ledger.refits}
        return ckpt.save(ckpt_dir, step, self._state_tree(), extra=extra)

    @classmethod
    def from_state(cls, config: Dict, tree: Dict, refits=(),
                   device: DeviceLike = None) -> "MedoidService":
        """A service in the state ``tree`` (a ``_state_tree()``, host
        arrays or tensors) under ``config`` (a ``config()``), with the
        ledger's refit records ``refits``, its medoids on ``device``."""
        cfg = dict(config)
        d = int(cfg.pop("d"))
        svc = cls(cfg.pop("k"), cfg.pop("metric"), device=device, **cfg)
        svc.d = d
        svc.reservoir = Reservoir(svc.reservoir_size, d, seed=svc.seed)
        med = tree["medoid_points"]
        if not isinstance(med, torch.Tensor):
            med = torch.tensor(np.asarray(med, np.float32))
        svc.medoid_points = med.to(resolve_device(device), torch.float32)
        svc.reservoir.load_state(tree["reservoir"])
        svc.drift.load_state(tree["drift"])
        svc.n_refits = int(tree["counters"]["n_refits"])
        svc.ledger.fresh = int(tree["counters"]["fresh"])
        svc.ledger.cached = int(tree["counters"]["cached"])
        svc.ledger.refits = [dict(r) for r in refits]
        return svc

    @classmethod
    def restore(cls, ckpt_dir: str, step: Optional[int] = None,
                device: DeviceLike = None, shardings=None
                ) -> "MedoidService":
        """Rebuild a service from a snapshot, its medoids on ``device``
        (``None``: the card); the host leaves come back as exact numpy.
        ``shardings`` (optional) is a tree like :meth:`_state_tree`: a
        ``NamedSharding`` for ``medoid_points`` reads it onto a mesh
        (each rank its own shard, then gathered: the service's kernels
        take the whole table), ``None`` for the host leaves."""
        extra = ckpt.read_extra(ckpt_dir, step=step)
        cfg = extra["service"]
        capacity, d = int(cfg["reservoir_size"]), int(cfg["d"])
        template = {
            "medoid_points": torch.zeros((int(cfg["k"]), d)),
            "reservoir": Reservoir(capacity, d).state(),
            "drift": DriftMonitor().state(),
            "counters": {"n_refits": np.int64(0), "fresh": np.int64(0),
                         "cached": np.int64(0)}}
        tree, _ = ckpt.restore(ckpt_dir, template, step=step,
                               device=resolve_device(device),
                               shardings=shardings)
        tree["medoid_points"] = to_local_full(tree["medoid_points"])
        return cls.from_state(cfg, tree, extra.get("refits", []), device)
