"""CLARA-style weighted reservoir over the ingest stream (counterpart of
``repro.serve.reservoir``).

A refit needs a sample that fits in one solver call and over-represents
the points the current medoids serve badly.  The sampling rule is A-Res
weighted reservoir sampling (Efraimidis & Spirakis 2006): stream point i
with weight ``w_i > 0`` draws ``u_i ~ U(0, 1)`` and gets the key
``r_i = u_i^(1/w_i)``; the reservoir keeps the ``capacity`` largest keys,
a weighted sample without replacement of everything ever offered,
whatever the chunking of the stream.

* ``u_i = uniform(fold_in(PRNGKey(seed), i))`` for the global stream
  index ``i``, the JAX package's draw bit for bit: jax casts the int64
  indices to int32 (64-bit types off) and ``fold_in`` takes the word as
  uint32, so the index enters as ``i mod 2**32``.  All of an offer's
  indices are one tensor computation of the port's threefry
  (:func:`stream_uniforms`), on the CPU: the service then reads
  nothing from the card for them, and the card gives the same bits.
* The merge is a host float64 lexsort on (key descending, stream index
  ascending), a total order, so ties cannot make two replicas diverge.

State is a flat dict of numpy arrays with the JAX reservoir's keys and
dtypes (:meth:`Reservoir.state`), so ``load_state`` takes a JAX
reservoir's ``state()`` unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import threefry

__all__ = ["Reservoir", "stream_uniforms"]


def stream_uniforms(key: threefry.Key, idx: np.ndarray) -> torch.Tensor:
    """``[m]`` float32 ``u_i = uniform(fold_in(key, i))`` for the int64
    stream indices ``idx``, computed on the CPU."""
    words = torch.as_tensor(np.asarray(idx, np.int64))
    return threefry.uniform(threefry.fold_in(key, words))


class Reservoir:
    """Bounded weighted sample of the ingest stream (A-Res keys).

    Args:
      capacity: maximum points held.
      d: feature dimension.
      seed: base PRNG key for the per-index uniforms.
    """

    def __init__(self, capacity: int, d: int, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.d = int(d)
        self.seed = int(seed)
        self._key = threefry.PRNGKey(self.seed)
        self.pts = np.zeros((self.capacity, self.d), np.float32)
        self.keys = np.full((self.capacity,), -np.inf, np.float64)
        self.sidx = np.full((self.capacity,), -1, np.int64)
        self.filled = 0
        self.seen = 0       # total stream points ever offered

    # -- ingest ----------------------------------------------------------
    def offer(self, points: np.ndarray, weights: Optional[np.ndarray] = None
              ) -> None:
        """Offer ``[m, d]`` points with optional positive weights.

        Stream indices are assigned internally (``seen .. seen+m``), so
        the chunking of a stream into offer() calls is not observable in
        the final reservoir.
        """
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2 or pts.shape[1] != self.d:
            raise ValueError(f"expected [m, {self.d}] points, "
                             f"got {pts.shape}")
        m = pts.shape[0]
        if m == 0:
            return
        if weights is None:
            w = np.ones((m,), np.float64)
        else:
            w = np.asarray(weights, np.float64).ravel()
            if w.shape[0] != m:
                raise ValueError("weights/points length mismatch")
            if (w <= 0).any():
                raise ValueError("weights must be positive")
        idx = self.seen + np.arange(m, dtype=np.int64)
        u = stream_uniforms(self._key, idx).numpy().astype(np.float64)
        # A-Res key in float64 on the host; u clamped away from 0 so the
        # log is finite.
        r = np.exp(np.log(np.maximum(u, 1e-300)) / w)

        cat_pts = np.concatenate([self.pts[:self.filled], pts])
        cat_keys = np.concatenate([self.keys[:self.filled], r])
        cat_sidx = np.concatenate([self.sidx[:self.filled], idx])
        # Total order: key desc, then stream index asc.
        order = np.lexsort((cat_sidx, -cat_keys))[:self.capacity]
        keep = len(order)
        self.pts[:keep] = cat_pts[order]
        self.keys[:keep] = cat_keys[order]
        self.sidx[:keep] = cat_sidx[order]
        self.keys[keep:] = -np.inf
        self.sidx[keep:] = -1
        self.filled = keep
        self.seen += m

    # -- views -----------------------------------------------------------
    @property
    def points(self) -> np.ndarray:
        """``[filled, d]`` view of the held points."""
        return self.pts[:self.filled]

    def __len__(self) -> int:
        return self.filled

    # -- checkpoint state ------------------------------------------------
    def state(self) -> dict:
        """Flat numpy state (float64 keys and int64 counters round-trip
        exactly through ``repro_torch.runtime.checkpoint``)."""
        return {"pts": self.pts.copy(), "keys": self.keys.copy(),
                "sidx": self.sidx.copy(),
                "filled": np.int64(self.filled),
                "seen": np.int64(self.seen)}

    def load_state(self, state: dict) -> None:
        pts = np.asarray(state["pts"], np.float32)
        if pts.shape != (self.capacity, self.d):
            raise ValueError(f"reservoir shape mismatch: snapshot "
                             f"{pts.shape} vs configured "
                             f"{(self.capacity, self.d)}")
        self.pts = pts.copy()
        self.keys = np.asarray(state["keys"], np.float64).copy()
        self.sidx = np.asarray(state["sidx"], np.int64).copy()
        self.filled = int(state["filled"])
        self.seen = int(state["seen"])
