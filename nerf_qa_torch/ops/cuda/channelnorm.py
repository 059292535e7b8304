"""Fused ChannelNorm(+GELU), forward and backward: the CUDA kernels'
wrappers, their plain versions and the autograd Function that joins them.

Replaces the Pallas TPU kernels ``nerf_qa_tpu/ops/pallas/channelnorm.py``
(``_fwd_kernel`` and ``_bwd_kernel``, joined there by the custom VJP
``_cn_act``). Per row of a (..., C) tensor: fp32 mean and centred variance
over C, then ``(x − mean)·rsqrt(var + eps)·scale + bias``, then the exact
(erf) GELU when asked; the output keeps the input's dtype
(``csrc/channelnorm.cu``). The TPU kernels' tanh GELU is not carried over:
the kernels compute what the decoder's ChannelNorm module computes, and
the backward differentiates the erf GELU.

Both kernels are bounded by device memory: the forward reads and writes
P·C elements, the backward reads x and the output gradient and writes dx
(3·P·C elements). The forward keeps a row in one warp's registers. In
the backward each warp streams its rows through its own ring in shared
memory with 16-byte copies whatever C's parity, on a grid that
:func:`_bwd_plan` sizes to the call; its dscale and dbias are column
sums over every row, written as per-block partial sums and added by a
second launch in a fixed order, so they repeat bit for bit.

:func:`channel_norm_act` takes a CPU tensor through
:func:`channel_norm_act_plain` (its gradient comes from autograd) and a
CUDA tensor through :class:`ChannelNormAct`, whose forward is the forward
kernel and whose backward is the backward kernel. There is no fallback
between them: a kernel that does not build or launch raises.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from nerf_qa_torch.utils.profiling import span

# Launches of the CUDA kernels: one per forward call on the card, one per
# backward call on the card.
launches = 0
bwd_launches = 0

MAX_CHANNELS = 1024  # 32 values a lane, one warp a row
BWD_WARPS = 8  # warps of a backward block (csrc kWarps), a row each at a time
BWD_MIN_ROWS = 2  # rows a backward warp takes at least: few partials
_DTYPES = (torch.float32, torch.bfloat16)
_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def channel_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, gelu: bool = False,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: the ChannelNorm module math of the JAX
    package (layers.py:91-101), statistics in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    if gelu:
        y = F.gelu(y)  # exact (erf), torch nn.GELU's default
    return y.to(x.dtype)


def channel_norm_act_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                               scale: torch.Tensor, bias: torch.Tensor, *,
                               gelu: bool = False, eps: float = 1e-5
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, written out as the kernel's
    formulas: (dx in x's dtype, dscale, dbias in fp32) for the output
    gradient ``g`` of :func:`channel_norm_act_plain`."""
    c = x.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xh = (xf - mean) * rstd
    s = scale.float()
    dy = g.float()
    if gelu:
        t = xh * s + bias.float()
        cdf = 0.5 * (1.0 + torch.erf(t * _SQRT_HALF))
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * t * t)
        dy = dy * (cdf + t * pdf)
    dscale = (dy * xh).reshape(-1, c).sum(0)
    dbias = dy.reshape(-1, c).sum(0)
    gs = dy * s
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - xh * (gs * xh).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale, dbias


def _check_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"need bfloat16 or float32 input, got {x.dtype}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if not (x.device == scale.device == bias.device):
        raise ValueError(f"inputs on {x.device}, {scale.device}, {bias.device}")
    return c


def _check_card(x: torch.Tensor, c: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no ChannelNorm kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous with channels last (an NCHW "
                         "map in channels_last memory seen through "
                         "permute(0, 2, 3, 1))")
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C = {c}: the kernel takes 1 <= C <= {MAX_CHANNELS}")
    if x.numel() // c >= 2**31:
        raise ValueError(f"{x.numel() // c} rows exceed the kernel's int index")


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """16-byte vectors a lane where C and every pointer allow, else 1."""
    vec = 16 // tensors[0].element_size()
    if c % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def _fwd_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                gelu: bool, eps: float) -> torch.Tensor:
    """Launch the forward kernel (x on the card, checked)."""
    global launches
    from nerf_qa_torch.ops.cuda import build

    c = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    lib = build.load_library()
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    with torch.cuda.device(x.device):
        code = lib.nqt_channel_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, c, float(eps), int(gelu), int(x.dtype == torch.bfloat16),
            _vec(c, x, out), torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_channel_norm")
    launches += 1
    return out


class BwdPlan(NamedTuple):
    """A backward launch: ``blocks`` blocks of BWD_WARPS warps; warp w of
    block b takes rows b · BWD_WARPS + w, then every blocks · BWD_WARPS-th
    row after it; each block writes one (2, C) partial into a buffer of
    shape ``partial``."""
    blocks: int
    partial: tuple[int, int, int]


def _bwd_plan(rows: int, c: int, sms: int, blocks_per_sm: int) -> BwdPlan:
    """The backward's grid for one call: at least BWD_MIN_ROWS rows a
    warp, so a small call writes few partials, and at most one resident
    wave, so every block runs at once."""
    blocks = -(-rows // (BWD_WARPS * BWD_MIN_ROWS))
    blocks = max(1, min(blocks, blocks_per_sm * sms))
    return BwdPlan(blocks, (blocks, 2, c))


@functools.cache
def _bwd_blocks_per_sm(device: torch.device, is_bf16: bool, c: int) -> int:
    """Resident backward blocks an SM at width ``c`` on ``device``, from
    the occupancy calculator (``nqt_channel_norm_bwd_attrs``), once per
    device, dtype and width."""
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    with torch.cuda.device(device):
        return build.kernel_attrs(lib.nqt_channel_norm_bwd_attrs, int(is_bf16),
                                  c)["blocks_per_sm"]


def channel_norm_act_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, *, gelu: bool = False,
                         eps: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of :func:`channel_norm_act` for the output
    gradient ``g`` (cast to x's dtype, as the JAX VJP does). CPU tensors
    take the plain version; CUDA tensors launch the backward kernel or
    raise."""
    global bwd_launches
    c = _check_args(x, scale, bias)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} must match x "
                         f"{tuple(x.shape)} on {x.device}")
    if g.dtype != x.dtype:
        g = g.to(x.dtype)
    if x.device.type == "cpu":
        return channel_norm_act_bwd_plain(x, g, scale, bias, gelu=gelu, eps=eps)
    _check_card(x, c)
    from nerf_qa_torch.ops.cuda import build

    rows = x.numel() // c
    if rows == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    # the host work of a call is as long as the kernel's at the small
    # widths: no copies or allocations beyond the outputs and the partials
    if not g.is_contiguous():
        g = g.contiguous()
    dx = torch.empty_like(x)
    # the finalize launch writes every element
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    is_bf16 = x.dtype == torch.bfloat16
    plan = _bwd_plan(rows, c, build.sm_count(x.device),
                     _bwd_blocks_per_sm(x.device, is_bf16, c))
    partial = torch.empty(plan.partial, dtype=torch.float32, device=x.device)
    lib = build.load_library()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    with torch.cuda.device(x.device):
        code = lib.nqt_channel_norm_bwd(
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), rows, c, float(eps), int(gelu), int(is_bf16),
            plan.blocks, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_channel_norm_bwd")
    bwd_launches += 1
    return dx, dscale, dbias


class ChannelNormAct(torch.autograd.Function):
    """ChannelNorm(+GELU) on the card: the forward kernel, and the
    backward kernel for its gradient (the TPU package's ``_cn_act``
    custom VJP). x must be contiguous rows; the saved x is the one the
    backward recomputes the statistics from. The backward runs in the span
    ``nr.cn_bwd:<rows>:<c>:<gelu>:<itemsize>``, on autograd's thread."""

    @staticmethod
    def forward(ctx, x, scale, bias, gelu: bool, eps: float):
        ctx.save_for_backward(x, scale, bias)
        ctx.gelu, ctx.eps = gelu, eps
        return _fwd_kernel(x, scale, bias, gelu, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        c = x.shape[-1]
        with span("nr.cn_bwd", lambda: (x.numel() // c, c, ctx.gelu, x.element_size())):
            dx, dscale, dbias = channel_norm_act_bwd(x, g, scale, bias,
                                                     gelu=ctx.gelu, eps=ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def channel_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, gelu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """ChannelNorm(+GELU) over the last axis of ``x``, same shape and dtype.
    CPU tensors take the plain version (gradient by autograd); CUDA tensors
    launch the forward kernel, and the backward kernel when autograd asks
    for a gradient, or raise."""
    c = _check_args(x, scale, bias)
    if x.device.type == "cpu":
        return channel_norm_act_plain(x, scale, bias, gelu=gelu, eps=eps)
    _check_card(x, c)
    return ChannelNormAct.apply(x, scale, bias, gelu, eps)
