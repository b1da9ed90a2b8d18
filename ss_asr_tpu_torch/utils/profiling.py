"""Per-step host timing.

``StepTimer`` copied from ``ss_asr_tpu/utils/profiling.py``: rolling
wall-clock stats around the train step, feeding the steps/sec and
utterances/sec scalars of the metric logger.  (The JAX device-trace helpers
are not ported: ``torch.profiler`` is used directly where a trace is taken.)
"""

from __future__ import annotations

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
