"""Profiling hooks: a trace on request, named ranges and a rolling step
timer.

Counterpart of ``nerf_qa_tpu/utils/profiling.py``. Reference behavior:
torch.profiler ``record_function("load_data") /
record_function("model_inference")`` scopes around the NR train loop
(train-nr.py:273,280; the enclosing profile() context is committed
disabled). Here ``record_function`` is ``torch.profiler.record_function``
itself: a range that costs nothing unless a profiler is recording, and
that ``chip_smoke.range_times`` reads from a trace. ``trace_if_enabled``
records such a trace when asked, and does nothing otherwise.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import record_function

__all__ = ["StepTimer", "TRACE_ENV", "record_function", "trace_if_enabled"]

TRACE_ENV = "NERF_QA_TORCH_TRACE_DIR"


@contextlib.contextmanager
def trace_if_enabled(trace_dir: str | None = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (host ops, and the device's
    kernels where CUDA is available), written to ``trace_dir`` or to
    ``$NERF_QA_TORCH_TRACE_DIR`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``; TensorBoard or
    chrome://tracing read it). Without either it does nothing."""
    trace_dir = trace_dir or os.environ.get(TRACE_ENV)
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(trace_dir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler):
        yield


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
