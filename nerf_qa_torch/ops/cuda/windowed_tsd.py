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

The kernel is bounded by operations (about 380 fp32 operations per output
pixel and channel). One block owns an output tile of 8 rows of one image
and one group of channels; it stages each chunk of channels with 16-byte
asynchronous copies and keeps the channel sum of its outputs in
registers. :func:`_plan` picks the tile (a wide or a narrow compiled
shape), the copy path and, where a stage gives too few blocks, a split of
the channels into groups whose partial maps a second launch adds in group
order: no atomics, results repeat bit for bit, no width cap. Inputs are
read in their own dtype (bf16 or fp32) and accumulated in fp32; the TPU
wrapper's bf16 downcast is dropped.

Forward only. :func:`windowed_tsd` takes CPU tensors through
:func:`windowed_tsd_plain` and CUDA tensors through the kernel; there is
no fallback between them.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from nerf_qa_torch.ops.windowed import fits_window, gaussian_taps, window_mean

# Launches of the CUDA kernel (one per windowed_tsd call on the card).
launches = 0

WINDOW = 21  # the kernel's window
_EPS = 1e-6
_DTYPES = (torch.float32, torch.bfloat16)

TILE_H = 8  # output rows of a block's tile
LANES = 4  # channels of a subpass; the plain-load path's chunk


class Shape(NamedTuple):
    """What the plan needs of a compiled tile shape of csrc/windowed_tsd.cu
    (``Wide``, ``Narrow``); its threads and shared memory stay in the
    source, held there by static_asserts."""
    tw_max: int  # output columns of a tile, at most
    blocks_per_sm: int


SHAPES = (Shape(108, 1), Shape(44, 2))
NARROW = 1


class Plan(NamedTuple):
    """One T/S launch: grid (tiles_h · tiles_w, N, groups) of the compiled
    ``shape``; tile (r, q) covers output rows [8r, 8r + 8) and columns
    [q · tw, q · tw + tw); group g sums channels [g · cg, min(C, g · cg +
    cg)) in chunks of ``ccb``."""
    shape: int
    tw: int
    tiles_w: int
    tiles_h: int
    groups: int
    cg: int
    ccb: int
    vec: bool  # 16-byte cp.async copies; else plain loads


def _plan(n: int, h: int, w: int, c: int, dtype: torch.dtype = torch.bfloat16,
          aligned: bool = True, sms: int = 132, shape: int | None = None) -> Plan:
    """Tiles, copy path and channel groups of one call. Stages at most 44
    outputs wide take the narrow shape; wider ones the wide shape, with the
    fewest column tiles of equal width. Channels are split where the tiles
    give fewer than two waves of blocks. ``shape`` forces a compiled shape
    (to time one against the other)."""
    hk, wk = h - WINDOW + 1, w - WINDOW + 1
    if shape is None:
        shape = NARROW if wk <= SHAPES[NARROW].tw_max else 0
    tiles_w = -(-wk // SHAPES[shape].tw_max)
    tw = -(-wk // tiles_w)
    tiles_h = -(-hk // TILE_H)
    vec_c = 16 // (2 if dtype == torch.bfloat16 else 4)
    vec = aligned and c % vec_c == 0
    ccb = vec_c if vec else LANES
    blocks = tiles_w * tiles_h * n
    want = 2 * SHAPES[shape].blocks_per_sm * sms
    groups = 1
    if blocks < want:
        groups = min(-(-want // blocks), -(-c // ccb), 65535)
    cg = ccb * math.ceil(math.ceil(c / groups) / ccb)
    return Plan(shape, tw, tiles_w, tiles_h, -(-c // cg), cg, ccb, vec)


_taps = None


def _taps_array():
    """The 21 Gaussian taps as a ctypes array, built once per process."""
    global _taps
    if _taps is None:
        _taps = (ctypes.c_float * WINDOW)(*gaussian_taps(WINDOW, WINDOW / 3.0))
    return _taps


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
    if inv_x is not None:
        inv_x = inv_x.float().contiguous()
        inv_y = inv_y.float().contiguous()
    plan = _plan(n, h, w, c, fx.dtype,
                 fx.data_ptr() % 16 == 0 and fy.data_ptr() % 16 == 0,
                 build.sm_count(fx.device))
    out = torch.empty((n, hk, wk), dtype=torch.float32, device=fx.device)
    partial = None
    if plan.groups > 1:
        partial = torch.empty((plan.groups, n, hk, wk), dtype=torch.float32,
                              device=fx.device)
    with torch.cuda.device(fx.device):
        code = lib.nqt_windowed_tsd(
            fx.data_ptr(), fy.data_ptr(), ps.data_ptr(), weights.data_ptr(),
            None if inv_x is None else inv_x.data_ptr(),
            None if inv_y is None else inv_y.data_ptr(),
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            n, h, w, c, int(fx.dtype == torch.bfloat16), int(plan.vec),
            plan.shape, plan.tw, plan.groups, plan.cg, _taps_array(), WINDOW,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_windowed_tsd")
    launches += 1
    return out
