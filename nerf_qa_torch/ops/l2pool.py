"""Anti-aliased L2 pooling (Hann-window energy pooling).

Counterpart of ``nerf_qa_tpu/ops/l2pool.py``. Reference behaviour:
DISTS_pt.py:11-25 (``L2pooling``): square the input, depthwise-convolve
with a normalised 3x3 Hann window (hanning(5) minus its endpoints),
stride 2, padding 1, then sqrt(· + 1e-12).

One formulation, ``F.conv2d(groups=C)`` through cuDNN, in the caller's
flow dtype; the JAX package's band-matmul branch was a size dispatch
measured on a TPU and is not carried over.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.cache
def hann_kernel(filter_size: int = 5) -> np.ndarray:
    """Normalised 2-D Hann window: outer(h, h)/sum, h = hanning(k)[1:-1]."""
    taps = np.hanning(filter_size)[1:-1]
    win = np.outer(taps, taps)
    return (win / win.sum()).astype(np.float32)


def hann_filter(channels: int, filter_size: int = 5) -> torch.Tensor:
    """(C, 1, k, k) depthwise filter: the reference ``L2pooling.filter``."""
    win = torch.from_numpy(hann_kernel(filter_size))
    return win[None, None].repeat(channels, 1, 1, 1)


def l2pool_nchw(x: torch.Tensor, filt: torch.Tensor, *,
                stride: int = 2) -> torch.Tensor:
    """L2 pooling of an NCHW tensor (channels_last memory is kept), in
    ``x.dtype``, with the (C, 1, k, k) window ``filt``."""
    c = x.shape[1]
    pad = (filt.shape[-1] - 1) // 2
    out = F.conv2d(x * x, filt.to(device=x.device, dtype=x.dtype),
                   stride=stride, padding=pad, groups=c)
    return out.add_(1e-12).sqrt_()


def l2pool(x: torch.Tensor, *, filter_size: int = 5,
           stride: int = 2) -> torch.Tensor:
    """L2 pooling over an NHWC tensor; output spatial dims
    floor((H + 2·pad − 3)/2) + 1 with pad = (filter_size − 2)//2 = 1."""
    filt = hann_filter(x.shape[-1], filter_size)
    y = l2pool_nchw(x.permute(0, 3, 1, 2), filt, stride=stride)
    return y.permute(0, 2, 3, 1)
