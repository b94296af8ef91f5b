"""Fault-tolerant training loop (``repro.runtime.fault``' counterpart):
periodic checkpoints, preemption-signal handling, bounded retry on
transient step failures, straggler detection.

The data pipeline is step-indexed and deterministic
(``repro_torch.train.data``), so recovery is: restore the latest
checkpoint (``runtime/checkpoint.py``) and fast-forward the step
counter.  The state is a nested dict of tensors (the model's and the
optimizer's).  The port's train step writes its tensors in place, so a
failure inside an update can leave the state in memory half written: a
retry therefore always restores a checkpoint, and ``run`` writes one at
its first step when the directory holds none.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import checkpoint as ckpt


@dataclass
class StragglerMonitor:
    """Tracks per-host step durations; flags hosts persistently slower than
    `factor` x the p50.  The launcher replaces flagged hosts; with a
    deterministic pipeline the replacement resumes from the checkpoint."""
    factor: float = 2.0
    window: int = 20
    history: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, host: int, dt: float) -> None:
        self.history.setdefault(host, []).append(dt)
        self.history[host] = self.history[host][-self.window:]

    def stragglers(self) -> List[int]:
        if not self.history:
            return []
        medians = {h: float(np.median(v)) for h, v in self.history.items()}
        p50 = float(np.median(list(medians.values())))
        return [h for h, m in medians.items()
                if m > self.factor * p50 and len(self.history[h]) >= 3]


class Preemption(Exception):
    pass


class FaultTolerantLoop:
    def __init__(self, ckpt_dir: str, save_every: int = 50,
                 max_retries: int = 3, install_sigterm: bool = True):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_retries = max_retries
        self.monitor = StragglerMonitor()
        self._preempted = False
        self._found: Optional[int] = None    # restore_or's latest step
        self._looked = False
        if install_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass  # not on main thread (tests)

    def _on_sigterm(self, *_):
        self._preempted = True

    # -- state = {"params": ..., "opt": ..., } --------------------------------
    def restore_or(self, state: Any, shardings: Any = None):
        """Resume from the latest checkpoint if one exists: ``(state,
        step)``, each leaf on its template's device, or placed by
        ``shardings`` (``checkpoint.restore``) where given."""
        step = ckpt.latest_step(self.ckpt_dir)
        self._found, self._looked = step, True
        # On a mesh every rank looks before any writes (run's first
        # checkpoint), so that all of them see the same directory.
        ckpt.sync(state)
        if step is None:
            return state, 0
        restored, meta = ckpt.restore(self.ckpt_dir, state, step=step,
                                      shardings=shardings)
        return restored, meta["step"]

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int, start_step: int = 0,
            on_metrics: Optional[Callable] = None) -> Any:
        """Run `step_fn(state, step) -> (state, metrics)` with checkpoints.

        Transient exceptions retry from the last checkpoint
        (deterministic data ⇒ bit-exact replay); with none in the
        directory (as ``restore_or`` found it, where it was called), one
        is written at ``start_step`` first, so a step that
        failed part-way through its in-place update is never replayed on
        top of it.  SIGTERM checkpoints and raises Preemption.
        """
        step = start_step
        retries = 0
        found = (self._found if self._looked
                 else ckpt.latest_step(self.ckpt_dir))
        if found is None:
            ckpt.save(self.ckpt_dir, step, state)
        while step < n_steps:
            if self._preempted:
                ckpt.save(self.ckpt_dir, step, state, extra={"reason": "preempt"})
                raise Preemption(f"preempted at step {step}")
            t0 = time.monotonic()
            try:
                state, metrics = step_fn(state, step)
            except Exception:
                retries += 1
                if retries > self.max_retries:
                    raise
                state, meta = ckpt.restore(self.ckpt_dir, state)
                step = meta["step"]
                continue
            retries = 0
            self.monitor.record(0, time.monotonic() - t0)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % self.save_every == 0:
                ckpt.save(self.ckpt_dir, step, state)
        return state
