"""ADISTS windowed γ sum: the CUDA kernel's wrapper and its plain version.

Replaces no TPU kernel: the JAX package's ``windowed_gamma_sum``
(``nerf_qa_tpu/core/adists.py``) is XLA band matmuls over channel blocks.
Per image and VALID output pixel of the 21×21 Gaussian window it gives
Σ_c (W(f²) − W(f)²) / (W(f) + 1e-12), the channel sum of γ at a stage
(``csrc/windowed_gamma.cu``).

The plain version loops over blocks of channels with
``ops/windowed.window_mean``, so that the VALID moment maps, which go
through device memory, never exist at full channel width. The kernel keeps
them on chip and writes only the (N, Hk, Wk) map: it needs no blocks.

The kernel is bounded by operations (about 174 fp32 operations per output
pixel and channel: two windowed moments by direct multiply-adds over the
21 taps in each pass). One block owns an output tile of 8 rows of one
image and one group of channels; it stages each chunk of channels with
16-byte asynchronous copies and keeps the channel sum of its outputs in
registers. :func:`_plan` picks the tile, the copy path and, where a stage
gives too few blocks, a split of the channels into groups whose partial
maps a second launch adds in group order: no atomics, results repeat bit
for bit. Inputs are read in their own dtype (bf16 or fp32) and
accumulated in fp32.

Forward only. ``core/adists.windowed_gamma_sum`` takes CPU tensors and
calls under autograd through :func:`windowed_gamma_sum_plain`, and CUDA
tensors otherwise through :func:`windowed_gamma_sum`; there is no fallback
between them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Iterator, NamedTuple

import torch

from nerf_qa_torch.ops.windowed import fits_window, gaussian_taps, window_mean

# Launches of the CUDA kernel (one per windowed_gamma_sum call on the card).
launches = 0

WINDOW = 21  # the kernel's window
_C0 = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)

TILE_H = 8  # output rows of a block's tile
TW_MAX = 108  # output columns of a tile, at most
LANES = 4  # channels of a subpass; the plain-load path's chunk
BLOCKS_PER_SM = 2  # of the compiled shape (its shared memory and threads
# stay in the source, held there by static_asserts)


class Plan(NamedTuple):
    """One γ launch: grid (tiles_h · tiles_w, N, groups); tile (r, q)
    covers output rows [8r, 8r + 8) and columns [q · tw, q · tw + tw);
    group g sums channels [g · cg, min(C, g · cg + cg)) in chunks of
    ``ccb``."""
    tw: int
    tiles_w: int
    tiles_h: int
    groups: int
    cg: int
    ccb: int
    vec: bool  # 16-byte cp.async copies; else plain loads


def _plan(n: int, h: int, w: int, c: int, dtype: torch.dtype = torch.bfloat16,
          aligned: bool = True, sms: int = 132) -> Plan:
    """Tiles, copy path and channel groups of one call: the fewest column
    tiles of equal width, and channels split where the tiles give fewer
    than two waves of blocks."""
    hk, wk = h - WINDOW + 1, w - WINDOW + 1
    tiles_w = -(-wk // TW_MAX)
    tw = -(-wk // tiles_w)
    tiles_h = -(-hk // TILE_H)
    vec_c = 16 // (2 if dtype == torch.bfloat16 else 4)
    vec = aligned and c % vec_c == 0
    ccb = vec_c if vec else LANES
    blocks = tiles_w * tiles_h * n
    want = 2 * BLOCKS_PER_SM * sms
    groups = 1
    if blocks < want:
        groups = min(-(-want // blocks), -(-c // ccb), 65535)
    cg = ccb * math.ceil(math.ceil(c / groups) / ccb)
    return Plan(tw, tiles_w, tiles_h, -(-c // cg), cg, ccb, vec)


_taps = None


def _taps_array():
    """The 21 Gaussian taps as a ctypes array, built once per process."""
    global _taps
    if _taps is None:
        _taps = (ctypes.c_float * WINDOW)(*gaussian_taps(WINDOW, WINDOW / 3.0))
    return _taps


def _channel_blocks(f: torch.Tensor, block: int) -> Iterator[torch.Tensor]:
    """The channel blocks of an NHWC map, ``block`` channels each (the
    last may be narrower: the JAX package zero-pads it for ``lax.scan``,
    and zero channels add nothing to the blocked sums)."""
    for c0 in range(0, f.shape[-1], block):
        yield f[..., c0:c0 + block]


def windowed_gamma_sum_plain(f: torch.Tensor, window_size: int, block: int) -> torch.Tensor:
    """Channel-blocked windowed var/mean ratio SUM over channels,
    (N, H, W, C) -> (N, Hk, Wk, 1): only ``block`` channels of VALID moment
    maps are live at a time. Callers divide by the channel count."""
    n, h, w, _ = f.shape
    hk, wk = h - window_size + 1, w - window_size + 1
    tot = torch.zeros((n, hk, wk), dtype=torch.float32, device=f.device)
    for fk in _channel_blocks(f, block):
        fk = fk.float()
        m = window_mean(fk, window_size)
        v = window_mean(fk * fk, window_size) - m.square()
        tot += (v / (m + _C0)).sum(dim=-1)
    return tot[..., None]


def windowed_gamma_sum(f: torch.Tensor, window_size: int = WINDOW) -> torch.Tensor:
    """The kernel: Σ_c windowed var / (mean + 1e-12), (N, Hk, Wk, 1) fp32.

    Args:
      f: (N, H, W, C) contiguous NHWC features on a CUDA device, bf16 or
        fp32, H and W at least the window.
    Raises on any other input; nothing falls back to the plain version.
    """
    global launches
    if f.dim() != 4:
        raise ValueError(f"need NHWC features, got shape {tuple(f.shape)}")
    n, h, w, c = f.shape
    if f.device.type != "cuda":
        raise ValueError(f"no windowed γ kernel for device {f.device}")
    if f.dtype not in _DTYPES:
        raise TypeError(f"need bfloat16 or float32 features, got {f.dtype}")
    if window_size != WINDOW:
        raise ValueError(f"the kernel takes a {WINDOW}x{WINDOW} window, got "
                         f"{window_size}")
    if not fits_window(h, w, window_size):
        raise ValueError(f"a {h}x{w} stage is smaller than the "
                         f"{window_size}x{window_size} window")
    if not f.is_contiguous():
        raise ValueError("features must be contiguous NHWC (a channels_last "
                         "NCHW map seen through permute(0, 2, 3, 1))")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid (65535)")
    if torch.is_grad_enabled() and f.requires_grad:
        raise RuntimeError("the windowed γ kernel has no backward; run under "
                           "torch.no_grad() or use windowed_gamma_sum_plain")
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    hk, wk = h - WINDOW + 1, w - WINDOW + 1
    plan = _plan(n, h, w, c, f.dtype, f.data_ptr() % 16 == 0,
                 build.sm_count(f.device))
    out = torch.empty((n, hk, wk), dtype=torch.float32, device=f.device)
    partial = None
    if plan.groups > 1:
        partial = torch.empty((plan.groups, n, hk, wk), dtype=torch.float32,
                              device=f.device)
    with torch.cuda.device(f.device):
        code = lib.nqt_windowed_gamma(
            f.data_ptr(), None if partial is None else partial.data_ptr(),
            out.data_ptr(), n, h, w, c, int(f.dtype == torch.bfloat16),
            int(plan.vec), plan.tw, plan.groups, plan.cg, _taps_array(), WINDOW,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_windowed_gamma")
    launches += 1
    return out[..., None]
