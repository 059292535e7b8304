"""Fused ChannelNorm(+GELU) forward: the CUDA kernel's wrapper and its plain
version.

Replaces the forward Pallas TPU kernel
``nerf_qa_tpu/ops/pallas/channelnorm.py`` (``_fwd_kernel``). Per row of a
(..., C) tensor: fp32 mean and centred variance over C, then
``(x − mean)·rsqrt(var + eps)·scale + bias``, then the exact (erf) GELU
when asked; the output keeps the input's dtype (``csrc/channelnorm.cu``).
The TPU kernel's tanh GELU is not carried over: the kernel computes what
the decoder's ChannelNorm module computes.

The kernel is bounded by device memory (one read and one write of P·C
elements); one warp per row keeps the row in registers between the two
reductions and the write.

Forward only: the backward kernel comes with NR training, so the wrapper
raises where autograd would need it. :func:`channel_norm_act` takes a CPU
tensor through :func:`channel_norm_act_plain` and a CUDA tensor through the
kernel; there is no fallback between them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel (one per channel_norm_act call on the card).
launches = 0

MAX_CHANNELS = 1024  # 32 values a lane, one warp a row
_DTYPES = (torch.float32, torch.bfloat16)


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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def channel_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     *, gelu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """ChannelNorm(+GELU) over the last axis of ``x``, same shape and dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"need bfloat16 or float32 input, got {x.dtype}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if not (x.device == scale.device == bias.device):
        raise ValueError(f"inputs on {x.device}, {scale.device}, {bias.device}")
    if _needs_grad(x, scale, bias):
        raise RuntimeError("the ChannelNorm kernel has no backward yet (it "
                           "comes with NR training); run under torch.no_grad() "
                           "or set ChannelNorm.fused = False")
    if x.device.type == "cpu":
        return channel_norm_act_plain(x, scale, bias, gelu=gelu, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no ChannelNorm kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous with channels last (an NCHW "
                         "map in channels_last memory seen through "
                         "permute(0, 2, 3, 1))")
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C = {c}: the kernel takes 1 <= C <= {MAX_CHANNELS}")
    from nerf_qa_torch.ops.cuda import build

    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed the kernel's int index")
    lib = build.load_library()
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    with torch.cuda.device(x.device):
        code = lib.nqt_channel_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, c, float(eps), int(gelu), int(x.dtype == torch.bfloat16),
            vec, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_channel_norm")
    launches += 1
    return out
