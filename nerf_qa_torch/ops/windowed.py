"""Windowed (local) statistics for ADISTS: Gaussian-weighted means over
sliding windows.

Counterpart of ``nerf_qa_tpu/ops/windowed.py``. Reference behaviour:
ADISTS.py:66-69,102-110 (21×21 Gaussian window, sigma = window / 3,
depthwise conv, stride 1, VALID padding) and :168-180 (the global-stats
fallback when the window exceeds the feature map).

The window is separable, and each 1-D pass takes one of two forms, chosen
by an H100 measurement (``chip_smoke.py``'s ``window_mean_choice`` phase,
PERF.md):

* a dense (out, in) band matrix applied with one matmul per axis, the JAX
  package's form. It wastes in / K of its FLOPs (12× at 256, 51× at
  1080), yet at the 256² ADISTS stages it is 3-10× faster than cuDNN's
  grouped convolution;
* a depthwise convolution with the 21 taps (``groups=C``) on the NCHW view
  of the NHWC map, which wins once H + W passes ``BAND_MAX_HW`` (the
  full-resolution stages).

Every window runs in true fp32, whatever the caller's context: cuDNN takes
fp32 convolutions through TF32 by default, and var = W(f²) − W(f)²
cancels (adists.py:360-375 records ~5e-3 score error from reduced-precision
moment maps).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nerf_qa_torch.config import true_fp32

# the band form up to this H + W, the convolution above (H100 measurement)
BAND_MAX_HW = 1536


@functools.cache
def gaussian_taps(window_size: int, sigma: float) -> tuple[float, ...]:
    """1-D normalized Gaussian (ADISTS.py:102-104)."""
    g = np.array([
        math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
        for x in range(window_size)
    ])
    return tuple(g / g.sum())


@functools.lru_cache(maxsize=64)
def _band_matrix(in_size: int, taps: tuple[float, ...],
                 device: torch.device) -> torch.Tensor:
    """(out, in) band matrix applying a VALID 1-D window: row o holds the
    taps at columns o..o+K-1 (kept on the device for the next call)."""
    k = len(taps)
    out_size = in_size - k + 1
    mat = np.zeros((out_size, in_size), np.float32)
    for i, t in enumerate(taps):
        mat[np.arange(out_size), np.arange(out_size) + i] = t
    return torch.from_numpy(mat).to(device)


def window_mean_band(x: torch.Tensor, taps: tuple[float, ...]) -> torch.Tensor:
    """The window as two dense band matmuls, (N, H, W, C) fp32 -> VALID."""
    n, h, w, c = x.shape
    # (Hk, H) @ (N, H, W·C), then (Wk, W) @ (N, Hk, W, C)
    y = torch.matmul(_band_matrix(h, taps, x.device),
                     x.reshape(n, h, w * c)).reshape(n, -1, w, c)
    return torch.matmul(_band_matrix(w, taps, x.device), y)


def window_mean_conv(x: torch.Tensor, taps: tuple[float, ...]) -> torch.Tensor:
    """The window as two depthwise convolutions (1×K along W, then K×1
    along H), (N, H, W, C) fp32 -> VALID."""
    k = len(taps)
    c = x.shape[-1]
    t = torch.tensor(taps, dtype=torch.float32, device=x.device)
    k_w = t.view(1, 1, 1, k).expand(c, 1, 1, k).contiguous()
    k_h = t.view(1, 1, k, 1).expand(c, 1, k, 1).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), k_w, groups=c)
    return F.conv2d(y, k_h, groups=c).permute(0, 2, 3, 1)


def window_mean(x: torch.Tensor, window_size: int = 21,
                sigma: float | None = None) -> torch.Tensor:
    """Gaussian windowed mean, VALID padding: (N, H, W, C) ->
    (N, H−K+1, W−K+1, C) fp32, contiguous NHWC. bf16 inputs are upcast;
    both passes run in true fp32 (the JAX ``precision`` argument has no
    counterpart: the port has one precision)."""
    if sigma is None:
        sigma = window_size / 3.0
    taps = gaussian_taps(window_size, sigma)
    h, w = x.shape[1], x.shape[2]
    body = window_mean_band if h + w <= BAND_MAX_HW else window_mean_conv
    with true_fp32():
        return body(x.float(), taps).contiguous()


def fits_window(h: int, w: int, window_size: int = 21) -> bool:
    """Whether VALID windowed stats are defined for an H×W map. The
    reference discovers this via try/except around the conv
    (ADISTS.py:78-97); here it is an explicit predicate."""
    return h >= window_size and w >= window_size
