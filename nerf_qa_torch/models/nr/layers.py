"""NR decoder building blocks as nn.Modules.

Counterpart of ``nerf_qa_tpu/models/nr/layers.py``. Reference behaviour:
model_nr_v8.py:17-51 (ConvLayer / ConvTransposeLayer: Dropout2d -> conv
-> ChannelNorm -> GELU), FeatUp's ChannelNorm (a per-pixel LayerNorm over
channels) and the vendored DINOv2 transformer blocks
(nerf_qa/layers/{block,attention,mlp,layer_scale}.py).

Key layout: the reference ``state_dict`` names, so reference checkpoints
load with ``strict=True``: ``conv.weight`` / ``conv.bias``,
``norm_layer.norm.weight`` / ``.bias``, and DINOv2's ``norm1``,
``attn.qkv``, ``attn.proj``, ``ls1.gamma``, ``norm2``, ``mlp.fc1``,
``mlp.fc2``, ``ls2.gamma``.

Layout: the conv layers take and return NCHW tensors, kept in
``channels_last`` memory by the decoder, so the ChannelNorm sees each map
as contiguous NHWC rows without a copy. The BatchNorm blocks of v1-v6 and
the sub-pixel transposed conv are not yet ported (ROADMAP Queue 1
item 11).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_qa_torch.ops.cuda.channelnorm import (
    channel_norm_act,
    channel_norm_act_plain,
)


class ChannelNorm(nn.Module):
    """LayerNorm over the channel axis at every pixel (FeatUp's
    ChannelNorm; model_nr_v8.py:22,40), with the block's exact GELU fused
    in when asked. Statistics in fp32; output in the input's dtype.
    ``norm`` holds the reference's ``weight`` / ``bias``.

    CUDA tensors take the ChannelNorm kernel (``ops/cuda/channelnorm.py``),
    CPU tensors its plain version; ``fused = False`` forces the plain
    version, the reference the kernel is held against."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.LayerNorm(features, eps=eps)
        self.eps = eps
        self.fused = True

    def forward(self, x: torch.Tensor, gelu: bool = False) -> torch.Tensor:
        """NCHW in, NCHW out (channels_last memory when ``x`` has it)."""
        rows = x.permute(0, 2, 3, 1)
        if self.fused and x.is_cuda:
            y = channel_norm_act(rows.contiguous(), self.norm.weight,
                                 self.norm.bias, gelu=gelu, eps=self.eps)
        else:
            y = channel_norm_act_plain(rows, self.norm.weight, self.norm.bias,
                                       gelu=gelu, eps=self.eps)
        return y.permute(0, 3, 1, 2)


class ConvLayer(nn.Module):
    """Dropout2d -> 3x3 conv -> ChannelNorm (+GELU when ``activation``)
    (model_nr_v8.py:17-33). Dropout2d is torch's: whole channels per
    sample, identity in eval mode."""

    def __init__(self, in_chns: int, out_chns: int, activation: bool = True,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout = nn.Dropout2d(dropout_rate)
        self.conv = nn.Conv2d(in_chns, out_chns, 3, padding=1)
        self.norm_layer = ChannelNorm(out_chns)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_layer(self.conv(self.dropout(x)), gelu=self.activation)


class ConvTransposeLayer(nn.Module):
    """Dropout2d -> exact-2x transposed conv -> ChannelNorm (+GELU)
    (model_nr_v8.py:35-51: ConvTranspose2d(k=3, s=2, p=1,
    output_padding=1)). The JAX package reproduces this alignment with
    padding ((1, 2), (1, 2)) and a spatially flipped kernel; the weight
    bridge undoes the flip (compat/from_jax.py)."""

    def __init__(self, in_chns: int, out_chns: int, activation: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout = nn.Dropout2d(dropout_rate)
        self.conv = nn.ConvTranspose2d(in_chns, out_chns, 3, stride=2,
                                       padding=1, output_padding=1)
        self.norm_layer = ChannelNorm(out_chns)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_layer(self.conv(self.dropout(x)), gelu=self.activation)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> fc2 (nerf_qa/layers/mlp.py)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    """Per-channel learned residual scale (nerf_qa/layers/layer_scale.py)."""

    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Attention(nn.Module):
    """Multi-head self-attention as explicit products with an fp32 softmax
    (layers.py:218-246): q is scaled before q·kᵀ, as the JAX package
    does."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (B, H, N, D)
        attn = torch.softmax((q * hd**-0.5) @ k.transpose(-2, -1), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block (nerf_qa/layers/block.py:36-131; no
    stochastic depth). ``layer_scale_init=None`` means no LayerScale, the
    reference decoder's Identity (init_values=None); ``qkv_bias=False`` is
    the reference decoder's setting. DINOv2's ViT has both, with LayerNorm
    eps 1e-6; the decoder's LayerNorms use torch's default 1e-5."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale_init: float | None = 1.0, norm_eps: float = 1e-5,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layer_scale_init is None:
            self.ls1 = self.ls2 = nn.Identity()
        else:
            self.ls1 = LayerScale(dim, layer_scale_init)
            self.ls2 = LayerScale(dim, layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def init_lecun_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in the JAX package's distribution (flax's
    lecun_normal kernels, zero biases; its numbers are not reproduced):
    every conv, transposed conv and linear weight ~ N(0, 1/fan_in)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = int(np.prod(w.shape[1:]))
                w.copy_(torch.randn(w.shape, generator=generator)
                        / np.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
    return module


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> the NCHW view in channels_last memory (no copy when ``x``
    is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when ``x`` is channels_last)."""
    return x.permute(0, 2, 3, 1)
