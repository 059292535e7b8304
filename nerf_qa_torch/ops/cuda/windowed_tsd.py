"""ADISTS windowed T/S distortion map: the CUDA kernel's wrapper and its
plain version.

Replaces the Pallas TPU kernel ``nerf_qa_tpu/ops/pallas/windowed_tsd.py``
(``_tsd_kernel``). Per image and VALID output pixel of the 21×21 Gaussian
window it gives Σ_c w_c·((1 − ps)·T_c + ps·S_c), where T and S are the
texture and structure ratios of the five windowed moments of the feature
pair (``csrc/windowed_tsd.cu``).

With ``inv_x`` / ``inv_y`` (per-channel scales, the inverse spatial L2
norms) the moments are scaled after windowing, as the JAX forward does
(adists.py:386-389): xm = ix·W(f), xv = ix²·var, xy = ix·iy·cov. The caller
then passes the raw VGG features, and no normalised copy is written.
Without them the call is the JAX ``windowed_tsd(fx, fy, ps, weights)``.

The kernel is bounded by operations (about 440 fp32 operations per output
pixel and channel). One block owns an output tile of one image and loops
over the channels in registers: no atomics, results repeat bit for bit,
no width cap. Inputs are read in their own dtype (bf16 or fp32) and
accumulated in fp32; the TPU wrapper's bf16 downcast is dropped.

Forward only. :func:`windowed_tsd` takes CPU tensors through
:func:`windowed_tsd_plain` and CUDA tensors through the kernel; there is
no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from nerf_qa_torch.ops.windowed import fits_window, gaussian_taps, window_mean

# Launches of the CUDA kernel (one per windowed_tsd call on the card).
launches = 0

WINDOW = 21  # the kernel's window
_EPS = 1e-6
_DTYPES = (torch.float32, torch.bfloat16)


def windowed_tsd_plain(fx: torch.Tensor, fy: torch.Tensor, ps: torch.Tensor,
                       weights: torch.Tensor, window_size: int = WINDOW,
                       inv_x: torch.Tensor | None = None,
                       inv_y: torch.Tensor | None = None,
                       channel_block: int = 16) -> torch.Tensor:
    """Plain PyTorch version, the ``window_mean`` composition of the JAX
    tests (tests/test_windowed_tsd_kernel.py), looped over channel blocks
    so that full-resolution moment maps never exist at full channel width:
    (N, H, W, C) pair -> (N, Hk, Wk) fp32."""
    n, h, w, c = fx.shape
    p = (ps[..., 0] if ps.dim() == 4 else ps).float()[..., None]
    weights = weights.float()
    out = None
    for c0 in range(0, c, channel_block):
        sl = slice(c0, min(c0 + channel_block, c))
        f = fx[..., sl].float()
        g = fy[..., sl].float()
        wf = window_mean(f, window_size)
        wg = window_mean(g, window_size)
        vf = window_mean(f * f, window_size) - wf.square()
        vg = window_mean(g * g, window_size) - wg.square()
        cov = window_mean(f * g, window_size) - wf * wg
        if inv_x is not None:
            ix = inv_x[:, None, None, sl].float()
            iy = inv_y[:, None, None, sl].float()
            wf, wg = ix * wf, iy * wg
            vf, vg = ix.square() * vf, iy.square() * vg
            cov = ix * iy * cov
        t = (2 * wf * wg + _EPS) / (wf.square() + wg.square() + _EPS)
        s = (2 * cov + _EPS) / (vf + vg + _EPS)
        d = (((1.0 - p) * t + p * s) * weights[:, None, None, sl]).sum(-1)
        out = d if out is None else out + d
    return out


def _check(fx, fy, ps, weights, window_size, inv_x, inv_y) -> None:
    if fx.shape != fy.shape or fx.dim() != 4:
        raise ValueError(f"need two equal NHWC shapes, got {tuple(fx.shape)} "
                         f"and {tuple(fy.shape)}")
    n, h, w, c = fx.shape
    if not fits_window(h, w, window_size):
        raise ValueError(f"a {h}x{w} stage is smaller than the "
                         f"{window_size}x{window_size} window")
    hk, wk = h - window_size + 1, w - window_size + 1
    if tuple(ps.shape) not in ((n, hk, wk), (n, hk, wk, 1)):
        raise ValueError(f"ps {tuple(ps.shape)}, expected ({n}, {hk}, {wk})")
    if (inv_x is None) != (inv_y is None):
        raise ValueError("pass both inv_x and inv_y, or neither")
    for name, t in (("weights", weights), ("inv_x", inv_x), ("inv_y", inv_y)):
        if t is not None and tuple(t.shape) != (n, c):
            raise ValueError(f"{name} {tuple(t.shape)}, expected ({n}, {c})")
    if fx.dtype != fy.dtype or fx.dtype not in _DTYPES:
        raise TypeError(f"need bfloat16 or float32 features, got {fx.dtype} "
                        f"and {fy.dtype}")
    tensors = [t for t in (fx, fy, ps, weights, inv_x, inv_y) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{ {t.device for t in tensors} }")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the windowed T/S kernel has no backward; run under "
                           "torch.no_grad() or use fused_tsd=False")


def windowed_tsd(fx: torch.Tensor, fy: torch.Tensor, ps: torch.Tensor,
                 weights: torch.Tensor, window_size: int = WINDOW,
                 inv_x: torch.Tensor | None = None,
                 inv_y: torch.Tensor | None = None) -> torch.Tensor:
    """Channel-weighted, ps-blended T/S distortion map, (N, Hk, Wk) fp32.

    Args:
      fx, fy: (N, H, W, C) contiguous NHWC features, bf16 or fp32.
      ps: (N, Hk, Wk) or (N, Hk, Wk, 1) structure probability map.
      weights: (N, C) channel weights.
      inv_x, inv_y: optional (N, C) per-channel scales of fx and fy.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    global launches
    _check(fx, fy, ps, weights, window_size, inv_x, inv_y)
    if fx.device.type == "cpu":
        return windowed_tsd_plain(fx, fy, ps, weights, window_size, inv_x, inv_y)
    if fx.device.type != "cuda":
        raise ValueError(f"no windowed T/S kernel for device {fx.device}")
    if window_size != WINDOW:
        raise ValueError(f"the kernel takes a {WINDOW}x{WINDOW} window, got "
                         f"{window_size}")
    if not (fx.is_contiguous() and fy.is_contiguous()):
        raise ValueError("features must be contiguous NHWC (a channels_last "
                         "NCHW map seen through permute(0, 2, 3, 1))")
    n, h, w, c = fx.shape
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid (65535)")
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    hk, wk = h - WINDOW + 1, w - WINDOW + 1
    ps = ps.reshape(n, hk, wk).float().contiguous()
    weights = weights.float().contiguous()
    if inv_x is None:
        inv_x = inv_y = torch.ones((n, c), dtype=torch.float32, device=fx.device)
    inv_x = inv_x.float().contiguous()
    inv_y = inv_y.float().contiguous()
    taps = (ctypes.c_float * WINDOW)(*gaussian_taps(WINDOW, WINDOW / 3.0))
    out = torch.empty((n, hk, wk), dtype=torch.float32, device=fx.device)
    with torch.cuda.device(fx.device):
        code = lib.nqt_windowed_tsd(
            fx.data_ptr(), fy.data_ptr(), ps.data_ptr(), weights.data_ptr(),
            inv_x.data_ptr(), inv_y.data_ptr(), out.data_ptr(), n, h, w, c,
            int(fx.dtype == torch.bfloat16), taps, WINDOW,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_windowed_tsd")
    launches += 1
    return out
