"""Learned joint-bilateral upsampling (JBU) semantic feature pyramid.

Counterpart of ``nerf_qa_tpu/models/nr/featup.py``. Reference behaviour:
model_nr_v8.py:112-136 — FeatUp's ``JBUStack``: four chained 2x guided
upsamplings (``up1..up4``, FeatUp ``JBULearnedRange``) plus a
``fixup_proj`` 0.1-residual projection at every level, giving the 6-level
semantic pyramid [16², 32², 64², 128², 256², 256²] of the RefineUp
decoder. Per stage:

* guidance = the image adaptive-average-pooled to 2x the source grid;
* range kernel = softmax over the 7x7 neighbourhood of
  clip(exp(range_temp), 1e-4, 1e4)·⟨proj(g), proj(g shifted)⟩, with
  ``range_proj`` = Conv1x1 -> GELU -> Dropout2d(0.1) -> Conv1x1;
* spatial kernel = a Gaussian over linspace(-1, 1, 7)² with learned
  ``sigma_spatial``;
* the normalised product filters the bicubic 2x upsample of the source,
  reflect-padded (``ops/cuda/jbu.py``: the CUDA kernel on the card, the
  scan formulation elsewhere).

Keys follow FeatUp's upsampler ``state_dict`` (``upN.range_temp``,
``upN.sigma_spatial``, ``upN.range_proj.{0,3}``, ``fixup_proj.1``).
Public tensors are NHWC, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_qa_torch.models.nr.layers import nchw, nhwc
from nerf_qa_torch.ops.cuda.jbu import jbu_filter, jbu_filter_plain
from nerf_qa_torch.ops.resize import adaptive_avg_pool, resize_bicubic
from nerf_qa_torch.utils.profiling import span


class JBU(nn.Module):
    """One learned 2x joint-bilateral upsampling stage (FeatUp
    ``JBULearnedRange(guidance_dim=3, feat_dim, key_dim=32, radius=3)``).

    CUDA tensors take the JBU kernel and CPU tensors the plain (scan)
    version; ``fused = False`` forces the plain version. The TPU's H % 8,
    W % 16 limits do not apply."""

    def __init__(self, dim: int, guidance_dim: int = 3, key_dim: int = 32,
                 radius: int = 3):
        super().__init__()
        self.dim = dim
        self.radius = radius
        self.fused = True
        self.range_proj = nn.Sequential(
            nn.Conv2d(guidance_dim, key_dim, 1), nn.GELU(), nn.Dropout2d(0.1),
            nn.Conv2d(key_dim, key_dim, 1))
        self.range_temp = nn.Parameter(torch.tensor(0.0))
        self.sigma_spatial = nn.Parameter(torch.tensor(1.0))

    def forward(self, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        """source (N, h, w, C); guidance (N, 2h, 2w, 3) already pooled to
        the target grid. Returns (N, 2h, 2w, C) fp32. Runs in the span
        ``nr.jbu:<n>:<2h>:<2w>:<C>:4``."""
        with span("nr.jbu", lambda: (*guidance.shape[:3], source.shape[-1], 4)):
            gh, gw = guidance.shape[1:3]
            d = 2 * self.radius + 1
            proj = nhwc(self.range_proj(nchw(guidance.float()))).contiguous()
            temp = torch.clamp(torch.exp(self.range_temp), 1e-4, 1e4)
            hr = resize_bicubic(source, gh, gw)
            with span("ops.upload", lambda: (4 * d * d,)):
                offs = np.linspace(-1.0, 1.0, d, dtype=np.float32)
                sq = (offs[:, None] ** 2 + offs[None, :] ** 2).reshape(-1)
                sq = torch.as_tensor(sq, device=hr.device)
            spatial = torch.exp(-sq / (2.0 * self.sigma_spatial**2))
            filt = jbu_filter if self.fused and hr.is_cuda else jbu_filter_plain
            return filt(hr, proj, spatial, temp, self.radius)


class JBUStack(nn.Module):
    """Four chained JBU stages + the fixup projection, producing the
    6-level semantic pyramid (model_nr_v8.py:121-132): the fixup
    (Dropout2d(0.2) -> Conv1x1) is applied to every level with a 0.1
    residual, and the 256² level appears twice."""

    def __init__(self, dim: int):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"up{i}", JBU(dim))
        self.fixup_proj = nn.Sequential(nn.Dropout2d(0.2), nn.Conv2d(dim, dim, 1))

    def forward(self, feats: torch.Tensor, image: torch.Tensor) -> list[torch.Tensor]:
        """feats (N, gh, gw, D) ViT patch map; image (N, H, W, 3) the
        semantic input. Returns six NHWC fp32 maps."""
        levels = [feats.float()]
        f = levels[0]
        for i in range(1, 5):
            h, w = f.shape[1:3]
            g = adaptive_avg_pool(image, h * 2, w * 2)
            f = getattr(self, f"up{i}")(f, g)
            levels.append(f)
        levels = [nhwc(self.fixup_proj(nchw(x))) * 0.1 + x for x in levels]
        return levels + [levels[-1]]
