"""Bilinear resize with exact torch ``F.interpolate`` geometry.

Counterpart of ``nerf_qa_tpu/ops/resize.py`` (``_resize_matrix``,
``resize_bilinear``, ``shortest_side_target``). The resize is two plain
matrix products with (out, in) interpolation matrices, as the JAX package
runs it; each row of a matrix holds the two lerp weights, so the fp32
results equal torch's gather-and-lerp. Bicubic, adaptive pooling and the
antialiased resize come with the NR slice.
"""
from __future__ import annotations

import numpy as np
import torch


def _resize_matrix(in_size: int, out_size: int,
                   align_corners: bool = False) -> np.ndarray:
    """(out, in) bilinear interpolation matrix in torch's two coordinate
    conventions (align_corners False: half-pixel centres)."""
    if align_corners:
        scale = (in_size - 1) / max(out_size - 1, 1)
        src = np.arange(out_size, dtype=np.float64) * scale
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    mat[rows, lo] += 1.0 - t
    mat[rows, hi] += t
    return mat


def resize_bilinear(
    x: torch.Tensor,
    out_h: int,
    out_w: int,
    *,
    compute_dtype: torch.dtype = torch.float32,
    scale: float = 1.0,
    align_corners: bool = False,
) -> torch.Tensor:
    """NHWC bilinear resize, no antialias; returns contiguous fp32 NHWC.

    Serving fast path: ``compute_dtype=torch.bfloat16`` runs both products
    in bf16 with fp32 accumulation; ``scale`` (e.g. 1/255 for uint8 input)
    is folded into the first interpolation matrix. The fp32 path needs
    full-fp32 matmuls: PyTorch's default (``allow_tf32`` False), and the
    fp32 pyramid's context sets it.
    """
    n, h, w, c = x.shape
    x = x.to(compute_dtype)
    first = True
    if h != out_h:
        ah = _resize_matrix(h, out_h, align_corners) * scale
        first = False
        ah = torch.as_tensor(ah, dtype=compute_dtype, device=x.device)
        # (O, H) @ (N, H, W·C) -> (N, O, W·C)
        x = torch.matmul(ah, x.reshape(n, h, w * c)).reshape(n, out_h, w, c)
    if w != out_w:
        aw = _resize_matrix(w, out_w, align_corners) * (scale if first else 1.0)
        first = False
        aw = torch.as_tensor(aw, dtype=compute_dtype, device=x.device)
        # (N, H', C, W) @ (W, P) -> (N, H', C, P) -> NHWC
        x = torch.matmul(x.transpose(2, 3), aw.t()).transpose(2, 3)
    out = x.float().contiguous()
    return out * scale if first else out


def shortest_side_target(h: int, w: int, side: int = 256) -> tuple[int, int]:
    """Aspect-preserving resize target: shortest side -> ``side``
    (the reference's keep_aspect_ratio geometry, DISTS_pt.py:212-213)."""
    if h <= w:
        return side, max(1, round(w * side / h))
    return max(1, round(h * side / w)), side
