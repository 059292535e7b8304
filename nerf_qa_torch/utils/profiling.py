"""Profiling hooks: named ranges and a rolling step timer.

Counterpart of ``nerf_qa_tpu/utils/profiling.py``, the part the FR
trainer CLI uses. Reference behavior: torch.profiler
``record_function("load_data") / record_function("model_inference")``
scopes around the NR train loop (train-nr.py:273,280). Here
``record_function`` is ``torch.profiler.record_function`` itself: a
range that costs nothing unless a profiler is recording, and that
``chip_smoke.range_times`` reads from a trace.
"""
from __future__ import annotations

import time

from torch.profiler import record_function

__all__ = ["StepTimer", "record_function"]


class StepTimer:
    """Rolling step-time tracker for throughput logs (tqdm-equivalent
    observability in headless runs)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def rate(self, items_per_step: int = 1) -> float:
        return items_per_step / self.mean if self.mean else 0.0
