"""Fused JBU adaptive filter: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``nerf_qa_tpu/ops/pallas/jbu.py``
(``_jbu_kernel``): FeatUp's joint-bilateral-upsampling filter. Per output
pixel, 49 range logits temp·⟨proj(centre), proj(shift)⟩ over a
reflect-padded K = 32 projection, their softmax times the 7×7 spatial
Gaussian, normalised, weight the 7×7 reflect-padded neighbourhood of the
bicubic-upsampled source ``hr`` over all C channels (``csrc/jbu.cu``).

The plain version is the scan formulation of the JAX module
(``models/nr/featup.py:94-131``): 49 shifted passes over the padded
projection and 49 over the padded source. The kernel makes one pass: a
block stages a 16×16 tile's projection and then its source, 32 channels at
a time, with their 3-pixel halo in shared memory, and each thread sums
2 × 4 pixels × 4 channels in registers, so it is bounded by
device memory, not by 49 re-reads. :func:`_plan` splits the channels
across blocks on the small levels, where the tiles alone give too few
blocks to fill the card.

Forward only (the JBU is part of the frozen encoder). :func:`jbu_filter`
takes CPU tensors through :func:`jbu_filter_plain` and CUDA tensors
through the kernel; there is no fallback between them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel (one per jbu_filter call on the card).
launches = 0

RADIUS = 3
KEY_DIM = 32
TILE = 16  # output pixels of a block's tile, each way
CHUNK = 32  # channels of a staged chunk; a channel group is a multiple
BLOCKS_PER_SM = 2
_DTYPES = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    """A JBU launch: grid (tiles_w, tiles_h, N · groups); block z of image
    n sums channels [g · cg, min(C, (g + 1) · cg)) of group g."""
    tiles_w: int
    tiles_h: int
    groups: int
    cg: int
    vec: bool  # 16-byte cp.async copies (fp32, C % 4 == 0, aligned)


def _plan(n: int, h: int, w: int, c: int, dtype: torch.dtype = torch.float32,
          aligned: bool = True, sms: int = 132) -> Plan:
    """Tiles and channel groups of one call. Where the tiles fill less than
    one wave of blocks (BLOCKS_PER_SM an SM), the channels are split into
    as many groups (a multiple of CHUNK channels each) as still fit in
    that wave: every group recomputes its tile's weights, so a second wave
    of groups would cost more than it hides. N · groups stays within the
    grid's 65535."""
    tiles_w, tiles_h = -(-w // TILE), -(-h // TILE)
    blocks = tiles_w * tiles_h * n
    groups = max(1, min(BLOCKS_PER_SM * sms // blocks, -(-c // CHUNK), 65535 // n))
    cg = CHUNK * math.ceil(math.ceil(c / groups) / CHUNK)
    vec = dtype == torch.float32 and c % 4 == 0 and aligned
    return Plan(tiles_w, tiles_h, -(-c // cg), cg, vec)


def _reflect_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC reflect padding of H and W by ``r`` (torch's mode: the edge
    pixel is not repeated)."""
    return F.pad(x.permute(0, 3, 1, 2), (r, r, r, r),
                 mode="reflect").permute(0, 2, 3, 1)


def jbu_filter_plain(hr: torch.Tensor, proj: torch.Tensor,
                     spatial: torch.Tensor, temp: torch.Tensor,
                     radius: int = RADIUS) -> torch.Tensor:
    """Plain PyTorch version, the scan formulation: (N, H, W, C) source and
    (N, H, W, K) projection -> (N, H, W, C) fp32."""
    n, h, w, c = hr.shape
    d = 2 * radius + 1
    hr = hr.float()
    proj = proj.float()
    proj_p = _reflect_pad(proj, radius)
    hr_p = _reflect_pad(hr, radius)
    logits = torch.stack(
        [(proj_p[:, p // d:p // d + h, p % d:p % d + w] * proj).sum(-1)
         for p in range(d * d)], dim=-1)
    range_k = torch.softmax(temp * logits, dim=-1)
    combined = range_k * spatial
    combined = combined / combined.sum(-1, keepdim=True).clamp_min(1e-7)
    out = torch.zeros((n, h, w, c), dtype=torch.float32, device=hr.device)
    for p in range(d * d):
        out += hr_p[:, p // d:p // d + h, p % d:p % d + w] * combined[..., p:p + 1]
    return out


def jbu_filter(hr: torch.Tensor, proj: torch.Tensor, spatial: torch.Tensor,
               temp: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """Fused JBU filter, (N, H, W, C) fp32. ``hr`` and ``proj`` share a
    dtype (fp32 or bf16, accumulated in fp32); ``spatial`` holds the
    (2r+1)² spatial weights and ``temp`` the range temperature, both on
    ``hr``'s device. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global launches
    n, h, w, c = hr.shape
    if proj.shape[:3] != hr.shape[:3] or proj.dim() != 4:
        raise ValueError(f"hr {tuple(hr.shape)} and proj {tuple(proj.shape)} "
                         "need the same (N, H, W)")
    if hr.dtype != proj.dtype or hr.dtype not in _DTYPES:
        raise TypeError(f"need bfloat16 or float32 hr and proj of one dtype, "
                        f"got {hr.dtype} and {proj.dtype}")
    if spatial.numel() != (2 * radius + 1) ** 2 or temp.numel() != 1:
        raise ValueError(f"spatial has {spatial.numel()} weights and temp "
                         f"{temp.numel()} values")
    devices = {t.device for t in (hr, proj, spatial, temp)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (hr, proj, spatial, temp)):
        raise RuntimeError("the JBU kernel has no backward (the JBU is part "
                           "of the frozen encoder); run under torch.no_grad() "
                           "or set JBU.fused = False")
    if hr.device.type == "cpu":
        return jbu_filter_plain(hr, proj, spatial, temp, radius)
    if hr.device.type != "cuda":
        raise ValueError(f"no JBU kernel for device {hr.device}")
    if radius != RADIUS or proj.shape[-1] != KEY_DIM:
        raise ValueError(f"the kernel takes radius {RADIUS} and K = {KEY_DIM}, "
                         f"got {radius} and {proj.shape[-1]}")
    if not (hr.is_contiguous() and proj.is_contiguous()):
        raise ValueError("hr and proj must be contiguous NHWC")
    if not (0 < n <= 65535 and h > radius and w > radius and c > 0):
        raise ValueError(f"shape {tuple(hr.shape)}: need 1 <= N <= 65535 and "
                         f"H, W > {radius} (reflect padding)")
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    spatial = spatial.detach().float().contiguous()
    temp = temp.detach().float().reshape(1).contiguous()
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=hr.device)
    plan = _plan(n, h, w, c, hr.dtype,
                 hr.data_ptr() % 16 == 0 and proj.data_ptr() % 16 == 0,
                 build.sm_count(hr.device))
    with torch.cuda.device(hr.device):
        code = lib.nqt_jbu_filter(
            hr.data_ptr(), proj.data_ptr(), spatial.data_ptr(), temp.data_ptr(),
            out.data_ptr(), n, h, w, c, int(hr.dtype == torch.bfloat16),
            int(plan.vec), plan.groups, plan.cg,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_jbu_filter")
    launches += 1
    return out
