"""Wall-clock step timing for the trainer's log line (counterpart of
``StepTimer`` in gigagan_tpu/utils/profiling.py)."""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


class StepTimer:
    """Rolling wall-clock stats over recent sync intervals.

    The trainer synchronises with the device only on logging steps, so a
    per-step start/stop time would measure the host's issue, not the work
    (a launch returns before the device runs it, and the log step absorbs
    the backlog).  Instead the trainer records one (elapsed, n_steps)
    sample per synchronisation, and the mean is total time over total
    steps across the window: right for any log cadence."""

    def __init__(self, window: int = 8):
        self.intervals = deque(maxlen=window)  # (elapsed_s, n_steps)
        self._t0: Optional[float] = None

    def start(self):
        """Mark the start of a sync interval (idempotent until stop)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def stop(self, n_steps: int = 1):
        """Record the interval since start() as `n_steps` steps' work.
        Call right after a device synchronisation."""
        if self._t0 is not None:
            self.record(time.perf_counter() - self._t0, n_steps)
            self._t0 = None

    def record(self, elapsed_s: float, n_steps: int):
        if n_steps > 0:
            self.intervals.append((elapsed_s, n_steps))

    @property
    def mean_s(self) -> float:
        steps = sum(n for _, n in self.intervals)
        if steps == 0:
            return 0.0
        return sum(t for t, _ in self.intervals) / steps

    def images_per_sec(self, batch_size: int) -> float:
        mean = self.mean_s
        return batch_size / mean if mean > 0 else 0.0

    def summary(self, batch_size: Optional[int] = None) -> str:
        if not self.intervals:
            return "no steps timed"
        msg = f"{self.mean_s * 1e3:.1f} ms/step"
        if batch_size:
            msg += f" ({self.images_per_sec(batch_size):.2f} img/s)"
        return msg
