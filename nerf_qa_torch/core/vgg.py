"""VGG16 five-stage feature pyramid (the DISTS backbone) as an nn.Module.

Counterpart of ``nerf_qa_tpu/core/vgg.py``. Reference behaviour:
DISTS_pt.py:27-55 — torchvision VGG16 ``features[0..29]`` split into five
stages at indices (0-3, 5-8, 10-15, 17-22, 24-29), every MaxPool (indices
4, 9, 16, 23) replaced by the anti-aliased L2 pool, ImageNet mean/std
normalisation before stage 1.

Parameters carry the reference DISTS key layout: ``stageK.{torchvision
idx}.weight/bias`` (OIHW), ``stageK.{pool idx}.filter`` and the ``mean`` /
``std`` buffers, so a reference ``model.pth`` (or the JAX package's
``compat/export_torch`` output) loads with ``load_state_dict(strict=True)``.
The backbone is frozen (``requires_grad`` False), as the reference's is.

Public functions take and return NHWC, as the JAX package does. Inside,
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW view in
``channels_last`` memory, and the pyramid stays in that format end to end,
so every returned feature map, seen as NHWC, is contiguous and the moments
kernel reads it without a copy.

Modes: fp32 (the parity path, run under ``true_fp32``: no TF32) and bf16
(conv outputs bf16, bias and ReLU in bf16, as vgg.py:71-96 does; the L2
pool runs in the flow dtype).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_qa_torch.config import true_fp32
from nerf_qa_torch.ops.l2pool import hann_filter, l2pool_nchw

# (in_channels, out_channels) per conv, per stage (DISTS_pt.py:36-49).
VGG16_STAGES: tuple[tuple[tuple[int, int], ...], ...] = (
    ((3, 64), (64, 64)),
    ((64, 128), (128, 128)),
    ((128, 256), (256, 256), (256, 256)),
    ((256, 512), (512, 512), (512, 512)),
    ((512, 512), (512, 512), (512, 512)),
)

# Channel width of each pyramid level [input, stage1..stage5]
# (DISTS_pt.py:57).
PYRAMID_CHANNELS: tuple[int, ...] = (3, 64, 128, 256, 512, 512)

# torchvision ``features`` index of each stage's convs and L2 pool
STAGE_CONV_INDICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
STAGE_POOL_INDEX = {2: 4, 3: 9, 4: 16, 5: 23}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_CL = torch.channels_last


class L2Pool(nn.Module):
    """The reference ``L2pooling`` module: a (C, 1, 3, 3) Hann ``filter``."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("filter", hann_filter(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2pool_nchw(x, self.filter)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std on the trailing channel axis (DISTS_pt.py:92)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> the NCHW view in channels_last memory (no copy when ``x`` is
    contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=_CL)


def _precision(dtype: torch.dtype):
    """fp32 runs its convs and matmuls in true fp32 (no TF32)."""
    return true_fp32() if dtype == torch.float32 else contextlib.nullcontext()


def _conv_relu(h: torch.Tensor, conv: nn.Conv2d,
               dtype: torch.dtype) -> torch.Tensor:
    """conv (output in ``dtype``), then bias and ReLU in ``dtype``."""
    y = F.conv2d(h.to(dtype), conv.weight.to(dtype), padding=1)
    return y.add_(conv.bias.to(dtype).view(1, -1, 1, 1)).relu_()


class VGG16Pyramid(nn.Module):
    """VGG16 stages 1-5 with L2 pooling, in the reference key layout."""

    def __init__(self):
        super().__init__()
        self.register_buffer(
            "mean", torch.from_numpy(IMAGENET_MEAN.reshape(1, 3, 1, 1).copy()))
        self.register_buffer(
            "std", torch.from_numpy(IMAGENET_STD.reshape(1, 3, 1, 1).copy()))
        for si, (spec, idxs) in enumerate(zip(VGG16_STAGES, STAGE_CONV_INDICES)):
            stage = nn.Module()
            if si > 0:
                stage.add_module(str(STAGE_POOL_INDEX[si + 1]), L2Pool(spec[0][0]))
            for (cin, cout), idx in zip(spec, idxs):
                stage.add_module(str(idx), nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(f"stage{si + 1}", stage)
        self.requires_grad_(False)

    def stage(self, stage_idx: int) -> nn.Module:
        """Stage 1..5: its L2 pool (stages 2-5) then its convs, in order."""
        return getattr(self, f"stage{stage_idx}")

    def _run_stage(self, stage_idx: int, h: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        for layer in self.stage(stage_idx).children():
            if isinstance(layer, L2Pool):
                h = layer(h)
            else:
                h = _conv_relu(h, layer, dtype)
        return h.contiguous(memory_format=_CL)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
        """NHWC images in [0, 1] -> ``[x, relu1_2, relu2_2, relu3_3,
        relu4_3, relu5_3]`` as NHWC tensors in ``compute_dtype`` (the
        feature list of DISTS.forward_once, DISTS_pt.py:91-103)."""
        feats = [x.to(compute_dtype).contiguous()]
        h = _nchw(x.float())
        h = (h - self.mean) / self.std
        with _precision(compute_dtype):
            for si in range(1, 6):
                # after stage 1, h is in the flow dtype; the pool keeps it
                h = self._run_stage(si, h, compute_dtype)
                feats.append(h.permute(0, 2, 3, 1))
        return feats


def init_he_normal(model: VGG16Pyramid, generator: torch.Generator) -> VGG16Pyramid:
    """He-normal conv weights and zero biases, drawn from ``generator`` on
    the CPU (the JAX package's ``init_vgg16_params`` distribution; not its
    numbers)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Conv2d):
                cout, cin, kh, kw = module.weight.shape
                w = torch.randn((cout, cin, kh, kw), generator=generator)
                module.weight.copy_(w * np.sqrt(2.0 / (kh * kw * cin)))
                module.bias.zero_()
    return model


def vgg16_pyramid(model: VGG16Pyramid, x: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """Functional form of ``model(x, compute_dtype)``."""
    return model(x, compute_dtype)


def vgg_stage_apply(model: VGG16Pyramid, stage_idx: int, x: torch.Tensor, *,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply one frozen stage (1-based) to NHWC ``x``. Stages 2-5 pool in
    fp32 first (the input is upcast), as the JAX ``vgg_stage_apply`` does."""
    with _precision(compute_dtype):
        return model._run_stage(stage_idx, _nchw(x.float()),
                                compute_dtype).permute(0, 2, 3, 1)
