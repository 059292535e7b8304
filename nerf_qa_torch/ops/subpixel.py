"""Sub-pixel (pixel-shuffle) form of the NR decoders' 2x transposed conv.

Counterpart of ``nerf_qa_tpu/ops/subpixel.py``. The decoders' upsample
layers are ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``
(model_nr_v8.py:35-51, model_nr.py:59-61): an input-dilated convolution
whose windows are 3/4 structural zeros. Split by output parity, each of
the four output subgrids reads a fixed subset of the taps over the
undilated input (torch weight ``w`` of shape (I, O, 3, 3)):

  out[2y  , 2x  ] = x[y, x]·w[1,1]
  out[2y  , 2x+1] = x[y, x]·w[1,2] + x[y, x+1]·w[1,0]
  out[2y+1, 2x  ] = x[y, x]·w[2,1] + x[y+1, x]·w[0,1]
  out[2y+1, 2x+1] = x[y, x]·w[2,2] + x[y, x+1]·w[2,0]
                    + x[y+1, x]·w[0,2] + x[y+1, x+1]·w[0,0]

packed here as one dense 2x2 convolution with 4·O outputs over the input
padded by one row and column (bottom, right), then ``pixel_shuffle``:
2.25x fewer multiply-adds than the dilated form, exact to float rounding.

Which form the decoders take (:func:`conv_transpose_2x`): the transposed
conv, on the card and on the CPU; the sub-pixel form only with the
environment variable ``NERF_QA_TORCH_SUBPIXEL_CT=1``, as the JAX package
reaches its own with ``NERF_QA_TPU_SUBPIXEL_CT=1`` (that opt-in came from
a TPU measurement and is not read here).
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

ENV = "NERF_QA_TORCH_SUBPIXEL_CT"

# The transposed conv is the default on CUDA tensors too: in chip_smoke.py's
# subpixel_choice phase (PERF.md §6, run F), at the v8 (bf16) and v1-v6
# (fp32) decoders' twelve transposed-conv shapes, batch 4, on an NVIDIA
# H100 80GB HBM3 at 700 W, it took 37.7 ms forward and backward summed over
# them against the sub-pixel form's 175.5 (12.1 against 22.8 forward
# alone): cuDNN runs it as a strided dgrad, while the sub-pixel form adds a
# padded copy, a 4·O-channel conv and a pixel-shuffle copy, and its
# backward reduces over the packed weight.


def pack_subpixel_weight(w: torch.Tensor) -> torch.Tensor:
    """Transposed-conv weight (I, O, 3, 3) -> the dense 2x2 conv weight
    (4·O, I, 2, 2) whose output channel ``o·4 + s`` holds subgrid ``s``
    (0: even row, even column; 1: even, odd; 2: odd, even; 3: odd, odd)
    of channel ``o``, the order ``F.pixel_shuffle`` reads."""
    i, o = w.shape[0], w.shape[1]
    k = w.permute(1, 0, 2, 3)  # (O, I, 3, 3)
    z = torch.zeros((o, i), dtype=w.dtype, device=w.device)
    # taps[s][dy][dx]: the input at (y + dy, x + dx) times this tap
    taps = [
        [[k[..., 1, 1], z], [z, z]],
        [[k[..., 1, 2], k[..., 1, 0]], [z, z]],
        [[k[..., 2, 1], z], [k[..., 0, 1], z]],
        [[k[..., 2, 2], k[..., 2, 0]], [k[..., 0, 2], k[..., 0, 0]]],
    ]
    packed = torch.stack([
        torch.stack([torch.stack(taps[s][dy], dim=-1) for dy in range(2)], dim=-2)
        for s in range(4)], dim=1)  # (O, 4, I, 2, 2)
    return packed.reshape(4 * o, i, 2, 2)


def conv_transpose_2x_subpixel(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, bias, stride=2, padding=1,
    output_padding=1)`` as a dense 2x2 conv and a pixel shuffle. NCHW
    ``x`` (I channels), ``weight`` (I, O, 3, 3) in x's dtype. The bias is
    added in fp32 and the result cast to x's dtype, as the JAX form does."""
    packed = pack_subpixel_weight(weight.to(x.dtype))
    y = F.conv2d(F.pad(x, (0, 1, 0, 1)), packed)  # (N, 4·O, H, W)
    y = F.pixel_shuffle(y, 2)  # (N, O, 2H, 2W)
    if bias is not None:
        y = (y.float() + bias.float()[None, :, None, None]).to(x.dtype)
    return y


def conv_transpose_2x_dense(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor | None = None) -> torch.Tensor:
    """The exact-2x transposed conv (k3, s2, p1, output_padding 1)."""
    return F.conv_transpose2d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype),
                              stride=2, padding=1, output_padding=1)


def subpixel_enabled(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the sub-pixel form: only with ``ENV`` set to 1."""
    return os.environ.get(ENV) == "1"


def conv_transpose_2x(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """The decoders' 2x upsample in the form :func:`subpixel_enabled`
    picks for ``x``."""
    if subpixel_enabled(x):
        return conv_transpose_2x_subpixel(x, weight, bias)
    return conv_transpose_2x_dense(x, weight, bias)
