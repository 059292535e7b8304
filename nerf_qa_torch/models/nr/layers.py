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

The v1-v6 blocks take ``norm_type="batch"``: BatchNorm then ReLU
(model_nr.py:90-94), keyed ``norm_layer.{weight, bias, running_mean,
running_var, num_batches_tracked}``. Its statistics follow flax's
``nn.BatchNorm``, as the JAX package does (:class:`BatchNorm`).

Data-parallel training (``train/nr_train.NRTrainer(mesh=...)``) keeps the
unsharded step's semantics: each shard passes a ``parallel.mesh.Shard`` in
place of the generator, whose dropout draws are the global batch's mask
at its rows and whose BatchNorm statistics are the global batch's (sums
over every shard of the step), as JAX's sharded batch statistics are.

Layout: the conv layers take and return NCHW tensors, kept in
``channels_last`` memory by the decoder, so the ChannelNorm sees each map
as contiguous NHWC rows without a copy. The 2x transposed convs go
through ``ops/subpixel.conv_transpose_2x``, which picks the transposed
conv or its sub-pixel form (:class:`SubpixelConvTranspose` is the latter
as a module, with the transposed conv's keys).

Precision (``dtype``, the JAX layers' ``dtype``): bf16 computation with
fp32 master weights cast at use. Convolutions and Dense layers take and
give bf16 (layers.py:131-197), the attention logits and softmax run in
fp32 and are cast back (layers.py:238-246), LayerNorms, LayerScale and the
residual stream stay fp32 (layers.py:263-272), and ChannelNorm keeps fp32
statistics with its output in the input's dtype. The casts are written
out; ``torch.autocast`` would place them elsewhere.
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
from nerf_qa_torch.ops.subpixel import conv_transpose_2x, conv_transpose_2x_subpixel
from nerf_qa_torch.parallel.mesh import Shard
from nerf_qa_torch.utils.profiling import span


class ChannelNorm(nn.Module):
    """LayerNorm over the channel axis at every pixel (FeatUp's
    ChannelNorm; model_nr_v8.py:22,40), with the block's exact GELU fused
    in when asked. Statistics in fp32; output in the input's dtype.
    ``norm`` holds the reference's ``weight`` / ``bias``.

    CUDA tensors take the ChannelNorm kernels (``ops/cuda/channelnorm.py``:
    the forward kernel, and the backward kernel when autograd needs a
    gradient), CPU tensors the plain version with autograd's gradient;
    ``fused = False`` forces the plain version, forward and backward, the
    reference the kernels are held against."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.LayerNorm(features, eps=eps)
        self.eps = eps
        self.fused = True

    def forward(self, x: torch.Tensor, gelu: bool = False) -> torch.Tensor:
        """NCHW in, NCHW out (channels_last memory when ``x`` has it), in
        the span ``nr.cn:<rows>:<c>:<gelu>:<itemsize>``."""
        c = x.shape[1]
        with span("nr.cn", lambda: (x.numel() // c, c, gelu, x.element_size())):
            rows = x.permute(0, 2, 3, 1)
            if self.fused and x.is_cuda:
                y = channel_norm_act(rows.contiguous(), self.norm.weight,
                                     self.norm.bias, gelu=gelu, eps=self.eps)
            else:
                y = channel_norm_act_plain(rows, self.norm.weight, self.norm.bias,
                                           gelu=gelu, eps=self.eps)
            return y.permute(0, 3, 1, 2)


def generator_at(generator, state: torch.Tensor):
    """A new generator of ``generator``'s kind (a ``torch.Generator`` or a
    ``parallel.mesh.Shard``) at ``state``: the replay of its draws."""
    if isinstance(generator, Shard):
        return generator.at(state)
    g = torch.Generator(device=generator.device)
    g.set_state(state)
    return g


class Dropout2d(nn.Module):
    """Channel dropout (torch Dropout2d semantics, layers.py:104-116):
    whole channels per sample are zeroed and the kept values scaled by
    1/keep. The mask is drawn from the explicit ``generator`` the caller
    passes (on the map's device), never from torch's global RNG, or from
    a data-parallel step's ``Shard`` (its rows of the global batch's
    mask); with no generator, in eval mode or at rate 0 it is the identity
    (the JAX module's ``deterministic``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NCHW in, NCHW out."""
        if self.rate == 0.0 or generator is None or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0], x.shape[1], 1, 1)
        if isinstance(generator, Shard):
            u = generator.rand(shape, x.device)
        else:
            u = torch.rand(shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Dense layer in ``dtype``: input, weight and bias cast at use."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype)
                    if layer.bias is not None else None)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW maps as flax's ``nn.BatchNorm`` computes it
    (the JAX package's v1-v6 blocks, layers.py:119-183), not torch's
    defaults (which the reference's ``nn.BatchNorm2d``, model_nr.py:91,
    used):

    * statistics in fp32 whatever the input's dtype, the variance as
      E[x²] − E[x]² clipped at 0 (flax's fast variance), biased;
    * running averages move as ``0.99·running + 0.01·batch`` (torch
      ``momentum=0.01``), the running variance from the biased batch
      variance; eps 1e-5;
    * in training mode the batch statistics normalise and the running
      averages update; in eval mode the running averages normalise.

    The output is ``(x − mean)·rsqrt(var + eps)·weight + bias`` in fp32,
    cast to ``dtype`` (flax's ``dtype``).

    Given the ``shard`` of a data-parallel step (``parallel.mesh.Shard``)
    the batch statistics are the global batch's (``Shard.batch_stats``),
    and only shard 0 moves the running averages."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.01)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, shard: Shard | None = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if shard is None:
                mean = xf.mean(dim=(0, 2, 3))
                var = ((xf * xf).mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
            else:
                mean, var = shard.batch_stats(xf)
            if shard is None or shard.index == 0:
                with torch.no_grad():
                    m = 1.0 - self.momentum
                    self.running_mean.copy_(m * self.running_mean + self.momentum * mean)
                    self.running_var.copy_(m * self.running_var + self.momentum * var)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(self.dtype)


def _norm_layer(norm_type: str, features: int, dtype: torch.dtype) -> nn.Module:
    if norm_type == "channel":
        return ChannelNorm(features)
    if norm_type == "batch":
        return BatchNorm(features, dtype)
    raise ValueError(f"norm_type {norm_type!r}: 'channel' or 'batch'")


class _ConvBlock(nn.Module):
    """Dropout2d -> conv -> norm (+activation): ChannelNorm with its exact
    GELU fused (``norm_type='channel'``, v7/v8), or BatchNorm then ReLU
    (``'batch'``, v1-v6). Its ``generator`` is the dropout generator or
    the ``Shard`` of a data-parallel step, which the BatchNorm takes too."""

    def _norm(self, x: torch.Tensor, generator) -> torch.Tensor:
        if isinstance(self.norm_layer, ChannelNorm):
            return self.norm_layer(x, gelu=self.activation)
        x = self.norm_layer(x, generator if isinstance(generator, Shard) else None)
        return torch.relu(x) if self.activation else x


class ConvLayer(_ConvBlock):
    """Dropout2d -> 3x3 conv -> norm (+activation) (model_nr_v8.py:17-33,
    model_nr.py:90-94), computed in ``dtype``."""

    def __init__(self, in_chns: int, out_chns: int, activation: bool = True,
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 norm_type: str = "channel"):
        super().__init__()
        self.dropout = Dropout2d(dropout_rate)
        self.conv = nn.Conv2d(in_chns, out_chns, 3, padding=1)
        self.norm_layer = _norm_layer(norm_type, out_chns, dtype)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.dropout(x.to(self.dtype), generator)
        x = F.conv2d(x, self.conv.weight.to(self.dtype),
                     self.conv.bias.to(self.dtype), padding=1)
        return self._norm(x, generator)


class ConvTransposeLayer(_ConvBlock):
    """Dropout2d -> exact-2x transposed conv -> norm (+activation)
    (model_nr_v8.py:35-51: ConvTranspose2d(k=3, s=2, p=1,
    output_padding=1)), computed in ``dtype``. The JAX package reproduces
    this alignment with padding ((1, 2), (1, 2)) and a spatially flipped
    kernel; the weight bridge undoes the flip (compat/from_jax.py)."""

    def __init__(self, in_chns: int, out_chns: int, activation: bool = False,
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 norm_type: str = "channel"):
        super().__init__()
        self.dropout = Dropout2d(dropout_rate)
        self.conv = nn.ConvTranspose2d(in_chns, out_chns, 3, stride=2,
                                       padding=1, output_padding=1)
        self.norm_layer = _norm_layer(norm_type, out_chns, dtype)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.dropout(x.to(self.dtype), generator)
        x = conv_transpose_2x(x, self.conv.weight.to(self.dtype),
                              self.conv.bias.to(self.dtype))
        return self._norm(x, generator)


class SubpixelConvTranspose(nn.ConvTranspose2d):
    """The exact-2x transposed conv (k3, s2, p1, output_padding 1) always
    in its sub-pixel form (``ops/subpixel.py``), with the transposed
    conv's parameters and ``state_dict`` keys, so the two modules' weights
    are interchangeable (the JAX package's ``SubpixelConvTranspose``,
    layers.py:36-56)."""

    def __init__(self, in_chns: int, out_chns: int):
        super().__init__(in_chns, out_chns, 3, stride=2, padding=1,
                         output_padding=1)

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        return conv_transpose_2x_subpixel(x, self.weight, self.bias)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> fc2 (nerf_qa/layers/mlp.py),
    in ``dtype``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, self.dtype)), self.dtype)


class LayerScale(nn.Module):
    """Per-channel learned residual scale (nerf_qa/layers/layer_scale.py)."""

    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Attention(nn.Module):
    """Multi-head self-attention as explicit products (layers.py:218-246):
    q is scaled before q·kᵀ, as the JAX package does; the projections run
    in ``dtype``, the logits, softmax and attention-weighted sum in fp32
    (the products of ``dtype`` values accumulated in fp32, JAX's
    ``preferred_element_type``), each cast back to ``dtype``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = _linear(self.qkv, x, self.dtype).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (B, H, N, D)
        logits = (q * hd**-0.5).float() @ k.float().transpose(-2, -1)
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = (attn.float() @ v.float()).transpose(1, 2).reshape(b, n, c)
        return _linear(self.proj, out, self.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block (nerf_qa/layers/block.py:36-131; no
    stochastic depth). ``layer_scale_init=None`` means no LayerScale, the
    reference decoder's Identity (init_values=None); ``qkv_bias=False`` is
    the reference decoder's setting. DINOv2's ViT has both, with LayerNorm
    eps 1e-6; the decoder's LayerNorms use torch's default 1e-5. With a
    bf16 ``dtype`` the attention and MLP compute in bf16 while the
    LayerNorms, LayerScale and the residual stream stay fp32."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale_init: float | None = 1.0, norm_eps: float = 1e-5,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        if layer_scale_init is None:
            self.ls1 = self.ls2 = nn.Identity()
        else:
            self.ls1 = LayerScale(dim, layer_scale_init)
            self.ls2 = LayerScale(dim, layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x))).float()
        return x + self.ls2(self.mlp(self.norm2(x))).float()


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
