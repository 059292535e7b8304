"""Fused DISTS moment sums: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``nerf_qa_tpu/ops/pallas/moments.py``
(``_moments_kernel``). Per image and channel of an NHWC feature pair it
gives Σx, Σy, Σx², Σy² and Σxy in fp32 (``csrc/moments.cu``).

The kernel is bounded by device memory: it reads 2·N·H·W·C·itemsize bytes
and does 5 multiply-adds per element pair. Its design answers that with
one read of each input (16-byte vector loads where C allows) and no
intermediate in device memory beyond the (N, P, 5, C) partial sums.

Numerics: fp32 accumulation over bounded per-thread runs, a fixed-order
tree in shared memory and a double-precision sum of the partials; no
atomics, so results repeat bit for bit. Variance and covariance are formed
single-pass, E[x²] − x̄² and E[xy] − x̄ȳ, as ``stage_stats_pallas`` does;
``core.dists.stage_stats_eager`` stays the two-pass oracle.

:func:`moment_sums` takes a CPU tensor through :func:`moment_sums_plain`
and a CUDA tensor through the kernel; there is no fallback between them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nerf_qa_torch.core.dists import StageStats

# Launches of the CUDA kernel (one per moment_sums call on the card).
launches = 0

_THREADS = 256
# pixels each thread accumulates before the block's tree reduction
_RUN = 32
_DTYPES = (torch.float32, torch.bfloat16)


class LaunchConfig(NamedTuple):
    vec: int  # channels per thread (one 16-byte load, or 1)
    cgb: int  # channel lanes per block
    pl: int  # pixel lanes per block
    chunk: int  # pixels per block
    p: int  # pixel chunks per image


def launch_config(hw: int, c: int, itemsize: int, aligned: bool) -> LaunchConfig:
    """Blocking of one kernel call: threads = cgb·pl ≤ 256, grid =
    (p, ⌈C / (vec·cgb)⌉, N), and every pixel lands in exactly one block
    (p·chunk ≥ hw > (p−1)·chunk)."""
    vec = 16 // itemsize
    if not aligned or c % vec:
        vec = 1
    n_cg = c // vec
    cgb = min(n_cg, _THREADS)
    pl = _THREADS // cgb
    chunk = pl * _RUN
    return LaunchConfig(vec, cgb, pl, chunk, max(1, math.ceil(hw / chunk)))


def moment_sums_plain(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W, C) pair -> (N, 5, C) fp32 sums."""
    x = fx.float()
    y = fy.float()
    dims = (1, 2)
    return torch.stack([x.sum(dims), y.sum(dims), (x * x).sum(dims),
                        (y * y).sum(dims), (x * y).sum(dims)], dim=1)


def _check(fx: torch.Tensor, fy: torch.Tensor) -> None:
    if fx.shape != fy.shape or fx.dim() != 4:
        raise ValueError(f"need two equal NHWC shapes, got {tuple(fx.shape)} "
                         f"and {tuple(fy.shape)}")
    if fx.dtype != fy.dtype or fx.dtype not in _DTYPES:
        raise TypeError(f"need bfloat16 or float32 features, got {fx.dtype} "
                        f"and {fy.dtype}")
    if fx.device != fy.device:
        raise ValueError(f"inputs on {fx.device} and {fy.device}")
    if fx.requires_grad or fy.requires_grad:
        raise RuntimeError("the moments kernel has no backward; detach the "
                           "features (stop_feature_grad) or use "
                           "stats_impl='eager'")
    if not (fx.is_contiguous() and fy.is_contiguous()):
        raise ValueError("features must be contiguous NHWC (a channels_last "
                         "NCHW map seen through permute(0, 2, 3, 1))")


def moment_sums(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Five moment sums of an NHWC pair, (N, 5, C) fp32. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    global launches
    _check(fx, fy)
    if fx.device.type == "cpu":
        return moment_sums_plain(fx, fy)
    if fx.device.type != "cuda":
        raise ValueError(f"no moments kernel for device {fx.device}")
    from nerf_qa_torch.ops.cuda import build

    n, h, w, c = fx.shape
    if not (0 < n <= 65535 and 0 < h * w < 2**31 and 0 < c):
        raise ValueError(f"shape {tuple(fx.shape)} is empty or exceeds the "
                         "kernel's grid")
    lib = build.load_library()
    aligned = fx.data_ptr() % 16 == 0 and fy.data_ptr() % 16 == 0
    cfg = launch_config(h * w, c, fx.element_size(), aligned)
    partial = torch.empty((n, cfg.p, 5, c), dtype=torch.float32, device=fx.device)
    out = torch.empty((n, 5, c), dtype=torch.float32, device=fx.device)
    with torch.cuda.device(fx.device):
        code = lib.nqt_moment_sums(
            fx.data_ptr(), fy.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h * w, c, int(fx.dtype == torch.bfloat16), cfg.vec, cfg.cgb,
            cfg.pl, cfg.chunk, cfg.p, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_moment_sums")
    launches += 1
    return out


def stats_from_sums(sums: torch.Tensor, hw: int) -> StageStats:
    """(N, 5, C) sums -> StageStats, as ``stage_stats_pallas`` forms them."""
    inv = 1.0 / hw
    mean_x = sums[:, 0] * inv
    mean_y = sums[:, 1] * inv
    var_x = sums[:, 2] * inv - mean_x.square()
    var_y = sums[:, 3] * inv - mean_y.square()
    cov = sums[:, 4] * inv - mean_x * mean_y
    return StageStats(mean_x, mean_y, var_x, var_y, cov)


def stage_stats_kernel(fx: torch.Tensor, fy: torch.Tensor) -> StageStats:
    """Drop-in for ``core.dists.stage_stats_eager``: one read of each input."""
    return stats_from_sums(moment_sums(fx, fy), fx.shape[1] * fx.shape[2])
