"""Plain PyTorch ADISTS, the reference of the ``adists`` configuration.

Ding et al., "Locally Adaptive Structure and Texture Similarity for Image
Quality Assessment" (ACM MM 2021), as its published ``ADISTS.py``
(https://github.com/dingkeyan93/A-DISTS) computes it, in NCHW:

- the pyramid of the ``dists`` reference (``reference/dists.py``, loaded
  by path and not copied): six levels of 3, 64, 128, 256, 512 and 512
  channels, 1475 in all;
- entropy weights from x only: ReLU, spatial L2 normalisation
  (``F.normalize`` over H and W), each channel a distribution over its
  pixels, its Shannon entropy in bits, normalised over the level's
  channels and scaled by C; over all 1475 channels the weights are
  normalised, clamped to mean ± 0.5·std and renormalised;
- windows: the 21×21 Gaussian of σ = 7 as a depthwise ``F.conv2d``, VALID;
- γ from x only: the channel mean of W(f²) − W(f)² over W(f) + 1e-12;
- the ps cascade, coarse to fine: ps = minmax(sigmoid((γ − mean γ) /
  (std γ + 1e-12))) times the coarser product resized by
  ``F.interpolate(..., align_corners=True)``, through minmax again; a level
  smaller than the window takes global moments and plain sigmoid(γ) times
  the coarser product resized to 1 × 1;
- T/S on the L2-normalised features: T = (2·x̄ȳ + ε) / (x̄² + ȳ² + ε),
  S = (2·cov + ε) / (σx² + σy² + ε), ε = 1e-6, D = Σ_levels mean_pixels
  Σ_c w_c·((1 − ps)·T + ps·S), and the score is 1 − D.

x is the distorted frame and y the reference frame, as the score tool
hands them to ADISTS.

Departures from ``ADISTS.py``:
- the means, standard deviations, minima and maxima of γ and ps, and the
  weights' clamp, are taken per image: the published code scores one pair
  at a time, where its batch statistics are the image's;
- std γ is the unbiased one (``torch.std``, as published) and the weights'
  std the population one, as the port takes them;
- VGG16's weights are the benchmark's seeded He-normal ones in place of
  torchvision's, and the pyramid is bf16 as the configuration states (its
  ``lower`` control rounds every convolution's operands to fp8);
- the head (weights, γ, the cascade and T/S) runs in true fp32: TF32 is
  switched off for the call;
- the windows take PyTorch's direct depthwise kernel, not cuDNN's: on an
  H100 cuDNN's implicit-GEMM algorithm for this 21×21 fp32 depthwise
  convolution returns ±3e-8 over windows of zeros, where γ's var / (mean
  + 1e-12) then divides by about zero, and a NaN or a wild γ spreads
  through the cascade to every finer level (a dead channel at 1080p's
  135 × 240 level does it).
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

WINDOW = 21
SIGMA = WINDOW / 3.0
C0 = 1e-12
EPS = 1e-6


def _dists_reference():
    """``reference/dists.py``, loaded by its path (under the key the
    benchmark's loader gives it, so both share one module)."""
    key = "portbench_file.reference_dists"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, Path(__file__).with_name("dists.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def gaussian_window(channels: int, device) -> torch.Tensor:
    """The (C, 1, 21, 21) normalised Gaussian of σ = 7 for a depthwise conv."""
    g = torch.tensor([math.exp(-((i - WINDOW // 2) ** 2) / (2 * SIGMA ** 2))
                      for i in range(WINDOW)], dtype=torch.float64)
    g = g / g.sum()
    win = torch.outer(g, g).float().to(device)
    return win[None, None].repeat(channels, 1, 1, 1)


def wmean(f: torch.Tensor) -> torch.Tensor:
    """Gaussian windowed mean of an NCHW map, VALID, as a direct depthwise
    convolution (PyTorch's own kernel, cuDNN off): a window over zeros is
    exactly zero."""
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(f, gaussian_window(f.shape[1], f.device), groups=f.shape[1])


def fits(f: torch.Tensor) -> bool:
    return f.shape[2] >= WINDOW and f.shape[3] >= WINDOW


def minmax(x: torch.Tensor) -> torch.Tensor:
    mn = x.amin(dim=(2, 3), keepdim=True)
    mx = x.amax(dim=(2, 3), keepdim=True)
    return (x - mn) / (mx - mn + C0)


def entropy(f: torch.Tensor) -> torch.Tensor:
    """(N, C) entropy weights of one level."""
    n, c = f.shape[:2]
    p = F.normalize(F.relu(f), dim=(2, 3)).reshape(n, c, -1)
    p = p / (p.sum(dim=2, keepdim=True) + C0)
    ent = (-p * torch.log2(p + C0)).sum(dim=2)
    return ent / (ent.sum(dim=1, keepdim=True) + C0) * c


def channel_weights(feats_x: list[torch.Tensor]) -> torch.Tensor:
    """(N, 1475) weights over the whole pyramid, clamped and renormalised."""
    w = torch.cat([entropy(f) for f in feats_x], dim=1)
    w = w / w.sum(dim=1, keepdim=True)
    mean = w.mean(dim=1, keepdim=True)
    std = w.std(dim=1, unbiased=False, keepdim=True)
    w = torch.clamp(w, mean - 0.5 * std, mean + 0.5 * std)
    return w / w.sum(dim=1, keepdim=True)


def compute_prob(feats_x: list[torch.Tensor]) -> list[torch.Tensor]:
    """The (N, 1, Hk, Wk) ps map of each level, cascaded coarse to fine."""
    x0 = feats_x[0]
    prod = torch.ones_like(x0[:, :1])
    out = []
    for f in reversed(feats_x):
        if fits(f):
            mean = wmean(f)
            var = wmean(f * f) - mean ** 2
            gamma = (var / (mean + C0)).mean(dim=1, keepdim=True)
            z = (gamma - gamma.mean(dim=(2, 3), keepdim=True)) / (
                gamma.std(dim=(2, 3), keepdim=True) + C0)
            ps = minmax(torch.sigmoid(z))
            up = F.interpolate(prod, size=ps.shape[2:], mode="bilinear", align_corners=True)
            prod = minmax(ps * up)
        else:
            mean = f.mean(dim=(2, 3), keepdim=True)
            var = ((f - mean) ** 2).mean(dim=(2, 3), keepdim=True)
            gamma = (var / (mean + C0)).mean(dim=1, keepdim=True)
            up = F.interpolate(prod, size=(1, 1), mode="bilinear", align_corners=True)
            prod = torch.sigmoid(gamma) * up
        out.append(prod)
    return out[::-1]


def score_feats(feats_x: list[torch.Tensor], feats_y: list[torch.Tensor]) -> torch.Tensor:
    """1 − D of two NCHW fp32 pyramids, per image."""
    weight = channel_weights(feats_x)
    ps_list = compute_prob(feats_x)
    d = torch.zeros(feats_x[0].shape[0], device=feats_x[0].device)
    lo = 0
    for fx, fy, ps in zip(feats_x, feats_y, ps_list):
        c = fx.shape[1]
        w = weight[:, lo:lo + c, None, None]
        lo += c
        x = F.normalize(fx, dim=(2, 3))
        y = F.normalize(fy, dim=(2, 3))
        if fits(fx):
            xm, ym = wmean(x), wmean(y)
            xv = wmean(x * x) - xm ** 2
            yv = wmean(y * y) - ym ** 2
            cov = wmean(x * y) - xm * ym
        else:
            xm = x.mean(dim=(2, 3), keepdim=True)
            ym = y.mean(dim=(2, 3), keepdim=True)
            xv = ((x - xm) ** 2).mean(dim=(2, 3), keepdim=True)
            yv = ((y - ym) ** 2).mean(dim=(2, 3), keepdim=True)
            cov = (x * y).mean(dim=(2, 3), keepdim=True) - xm * ym
        t = (2 * xm * ym + EPS) / (xm ** 2 + ym ** 2 + EPS)
        s = (2 * cov + EPS) / (xv + yv + EPS)
        d_map = (((1 - ps) * t + ps * s) * w).sum(dim=1)
        d = d + d_map.mean(dim=(1, 2))
    return 1 - d


@torch.no_grad()
def score_frames(state: dict, dist: torch.Tensor, ref: torch.Tensor,
                 dtype=torch.bfloat16, lower: bool = False, block: int = 8) -> torch.Tensor:
    """ADISTS(dist, ref) of NHWC float frame pairs in [0, 1], ``block``
    pairs at a time: the pyramid in ``dtype`` (``lower``: its fp8
    control), the head in fp32; fp32 scores on the frames' device."""
    dists = _dists_reference()
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for lo in range(0, dist.shape[0], block):
            x = dists.frames_to_unit(dist[lo:lo + block], None)
            y = dists.frames_to_unit(ref[lo:lo + block], None)
            fx = [f.float() for f in dists.pyramid(state, x, dtype, lower)]
            fy = [f.float() for f in dists.pyramid(state, y, dtype, lower)]
            out.append(score_feats(fx, fy))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
