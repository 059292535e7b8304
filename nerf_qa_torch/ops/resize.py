"""Bilinear and bicubic resize and adaptive average pooling with exact torch
``F.interpolate`` / ``F.adaptive_avg_pool2d`` geometry.

Counterpart of ``nerf_qa_tpu/ops/resize.py`` (``_resize_matrix``,
``resize_bilinear``, ``_cubic_weights``, ``_bicubic_matrix``,
``resize_bicubic``, ``adaptive_avg_pool``, ``resize_bilinear_aa``,
``shortest_side_target``). Each resize but the antialiased one is two
plain matrix products with the JAX package's (out, in) matrices; a row
holds the lerp, cubic or bin weights, so the fp32 results equal torch's
gather form to rounding.

The matrices are built on the host at each call and copied to the input's
device, each in the span ``ops.upload:<bytes>``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from nerf_qa_torch.utils.profiling import span


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


def _upload(build, shape: tuple[int, int], dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The host-built matrix ``build()`` of ``shape`` as a ``dtype`` tensor
    on ``device``: build and copy in the span ``ops.upload:<bytes>``."""
    with span("ops.upload", lambda: (math.prod(shape) * dtype.itemsize,)):
        return torch.as_tensor(build(), dtype=dtype, device=device)


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
        ah = _upload(lambda: _resize_matrix(h, out_h, align_corners) * scale,
                     (out_h, h), compute_dtype, x.device)
        first = False
        # (O, H) @ (N, H, W·C) -> (N, O, W·C)
        x = torch.matmul(ah, x.reshape(n, h, w * c)).reshape(n, out_h, w, c)
    if w != out_w:
        scale_w = scale if first else 1.0
        aw = _upload(lambda: _resize_matrix(w, out_w, align_corners) * scale_w,
                     (out_w, w), compute_dtype, x.device)
        first = False
        # (N, H', C, W) @ (W, P) -> (N, H', C, P) -> NHWC
        x = torch.matmul(x.transpose(2, 3), aw.t()).transpose(2, 3)
    out = x.float().contiguous()
    return out * scale if first else out


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic-convolution tap weights for fractional offsets ``t`` in [0,1).

    Returns (len(t), 4) weights for taps at offsets (-1, 0, 1, 2) relative
    to floor(src) — the kernel torch uses for mode='bicubic' (A=-0.75).
    """
    t = np.asarray(t, np.float64)

    def k1(x):  # |x| <= 1
        return (a + 2) * x**3 - (a + 3) * x**2 + 1

    def k2(x):  # 1 < |x| < 2
        return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a

    return np.stack(
        [k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=1
    ).astype(np.float32)


def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bicubic interpolation matrix matching torch
    ``F.interpolate(mode='bicubic', align_corners=False)`` (half-pixel
    centers, A=-0.75, border-clamped taps)."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base
    w = _cubic_weights(t)
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for k in range(4):
        idx = np.clip(base - 1 + k, 0, in_size - 1)
        np.add.at(mat, (rows, idx), w[:, k])
    return mat


def _pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) adaptive-average-pool matrix: output bin i averages
    input[floor(i·in/out) : ceil((i+1)·in/out)]. Bins overlap when
    out > in (224 -> 256), as torch's do."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def _separable(x: torch.Tensor, matrix, out_h: int, out_w: int) -> torch.Tensor:
    """Apply the (out, in) matrices ``matrix(in, out)`` along H and W of an
    NHWC tensor, in fp32 (none along an axis that keeps its size)."""
    n, h, w, c = x.shape
    x = x.float()
    if h != out_h:
        a = _upload(lambda: matrix(h, out_h), (out_h, h), torch.float32, x.device)
        x = torch.matmul(a, x.reshape(n, h, w * c)).reshape(n, -1, w, c)
    if w != out_w:
        a = _upload(lambda: matrix(w, out_w), (out_w, w), torch.float32, x.device)
        x = torch.matmul(a, x)  # (P, W) @ (N, H', W, C) -> (N, H', P, C)
    return x.contiguous()


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC bicubic resize, fp32, torch semantics (align_corners=False, no
    antialias). The FeatUp JBU upsampler bicubic-upsamples its source
    before the adaptive filter."""
    return _separable(x, _bicubic_matrix, out_h, out_w)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC adaptive average pooling, fp32, torch semantics. FeatUp's
    JBUStack pools the guidance image to 2x the source grid at every
    stage, up to 256² from a 224² image."""
    return _separable(x, _pool_matrix, out_h, out_w)


def resize_bilinear_aa(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of NHWC, fp32: the triangle kernel
    widened by the scale when downsampling, plain bilinear when
    upsampling. The JAX package leaves it to ``jax.image.resize(...,
    "bilinear")``; torch's ``F.interpolate(antialias=True)`` computes the
    same weights (tests/test_torch_resize_aa.py holds it to rtol 1e-5,
    atol 1e-6)."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


def shortest_side_target(h: int, w: int, side: int = 256) -> tuple[int, int]:
    """Aspect-preserving resize target: shortest side -> ``side``
    (the reference's keep_aspect_ratio geometry, DISTS_pt.py:212-213)."""
    if h <= w:
        return side, max(1, round(w * side / h))
    return max(1, round(h * side / w)), side
