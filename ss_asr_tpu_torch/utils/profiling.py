"""Per-step host timing and optional traces.

Port of ``ss_asr_tpu/utils/profiling.py``:

* ``StepTimer`` (copied): rolling wall-clock stats around the train step,
  feeding the steps/sec and utterances/sec scalars of the metric logger;
* ``device_trace``: a ``torch.profiler`` trace of a window of steps (the
  CPU and, when a card is present, its CUDA activity) written as a Chrome /
  Perfetto trace file under ``logdir``, gated so that it costs nothing when
  unused; the JAX package's is a ``jax.profiler`` trace;
* ``annotate``: a named region (``torch.profiler.record_function``) that
  shows up in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Optional


class StepTimer:
    """Rolling wall-clock timing across training steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._durations: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the last step's duration (or None)."""
        now = time.perf_counter()
        dur = None
        if self._last is not None:
            dur = now - self._last
            self._durations.append(dur)
        self._last = now
        return dur

    def reset(self) -> None:
        self._last = None
        self._durations.clear()

    @property
    def steps_per_sec(self) -> float:
        if not self._durations:
            return 0.0
        return len(self._durations) / sum(self._durations)

    def utt_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec * batch_size


@contextlib.contextmanager
def device_trace(logdir: str, enabled: bool = True):
    """Trace the block with ``torch.profiler`` into
    ``<logdir>/trace_<pid>_<n>.json``; yields the profiler (None when not
    ``enabled``)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in a ``device_trace``."""
    from torch.profiler import record_function

    with record_function(name):
        yield
