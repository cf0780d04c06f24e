"""Wall-clock step timing for the trainer's log line (counterpart of
``StepTimer`` in gigagan_tpu/utils/profiling.py), and the named phase
spans the trainer and the sampler record for ``torch.profiler``."""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import torch

# Every span the port records.  ``gigagan.train.iteration`` holds every
# other train span of its iteration (``gigagan.train.loader_close``, once
# per ``forward`` call, follows the last), ``gigagan.sample.request``
# every sample span of its request; ``gigagan.sync.*`` covers a call on
# the train or sample path at which the host waits for the card.
# ``gigagan.sample.graph_capture`` and ``.graph_replay`` lie inside
# ``gigagan.sample.generator``: a capture of G's forward as a CUDA graph,
# and a replay of one (``train/sample_graph.py``).
SPANS = (
    "gigagan.train.iteration",
    "gigagan.train.batch",
    "gigagan.train.data_wait",
    "gigagan.train.d_step",
    "gigagan.train.g_step",
    "gigagan.train.log",
    "gigagan.train.loader_close",
    "gigagan.d.fakes",
    "gigagan.d.loss",
    "gigagan.d.backward",
    "gigagan.d.r1_chunked",
    "gigagan.d.optimizer",
    "gigagan.g.loss",
    "gigagan.g.backward",
    "gigagan.g.optimizer",
    "gigagan.g.ema",
    "gigagan.clip.embed_texts",
    "gigagan.sample.request",
    "gigagan.sample.generator",
    "gigagan.sample.graph_capture",
    "gigagan.sample.graph_replay",
    "gigagan.sync.batch_to_device",
    "gigagan.sync.blur_kernel",
    "gigagan.sync.resize_index",
    "gigagan.sync.clip_tokens",
    "gigagan.sync.clip_normalize",
    "gigagan.sync.clip_logit_scale",
    "gigagan.sync.readback",
)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a profiler ``cpu_op`` event on
    the calling thread while a ``torch.profiler`` profile runs, and the
    shared no-op context otherwise.

    ``_RecordFunctionFast`` and not ``record_function``: the latter records
    a user annotation, which Kineto mirrors onto the device's timeline,
    where it would read as device activity."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


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
