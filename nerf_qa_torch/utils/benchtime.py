"""Op timing: seconds per run of N back-to-back runs of one op.

Counterpart of ``nerf_qa_tpu/utils/benchtime.py``. The JAX harness runs
its N iterations inside one jitted ``lax.fori_loop`` with a scalar
feedback between them, so that XLA can neither hoist nor elide a run.
Eager PyTorch has no compiler to do either, and one stream runs the
launches in order; what a host clock gets wrong there is the
asynchronous launch. So on a CUDA tensor the N runs sit between two CUDA
events, after one warm-up run, and on a CPU tensor between two
``perf_counter`` reads. Each run's output feeds one device scalar (its
first element, added in: one one-element kernel a run), which the host
reads at the end, so every run has a consumer and has finished.

No reference equivalent (the reference never measures kernels); used by
``chip_smoke.py``'s kernel timings.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _feed(acc: torch.Tensor, out) -> None:
    if torch.is_tensor(out) and out.numel():
        acc.add_(out.reshape(-1)[0].to(acc.device, torch.float32))


def bench_op(op: Callable[[torch.Tensor], object], x: torch.Tensor,
             iters: int = 20, warmup: bool = True) -> float:
    """Seconds per run of ``op(x)`` over ``iters`` back-to-back runs, on
    ``x``'s device (CUDA events for a CUDA tensor, the host clock for a
    CPU tensor)."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    if warmup:
        _feed(acc, op(x))
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            _feed(acc, op(x))
        end.record()
        end.synchronize()
        float(acc)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        _feed(acc, op(x))
    float(acc)
    return (time.perf_counter() - t0) / iters
