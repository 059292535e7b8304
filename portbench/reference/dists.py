"""Plain PyTorch DISTS, the reference of the ``dists`` configuration.

Ding et al., "Image Quality Assessment: Unifying Structure and Texture
Similarity" (TPAMI 2020), as its published ``DISTS_pt.py`` computes it:
ImageNet normalisation, VGG16 conv1_1-conv5_3 with every max pool replaced
by the Hann-window L2 pool, the six feature levels [x, relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3], per channel S1 = (2 x̄ ȳ + c1) / (x̄² + ȳ² + c1)
and S2 = (2 cov + c2) / (var_x + var_y + c2) over the spatial positions,
and score = 1 − Σ (α S1 + β S2) with α, β divided by their joint sum.

It imports nothing of the program. It takes the benchmark's weights (a
state dictionary in the reference DISTS key layout) and the bundled α/β
file, and works out the Hann window, the normalisation and the resize
itself. Frames are resized from uint8 by ``F.interpolate`` (bilinear,
half-pixel centres, no antialias) in fp32.

Precision: ``dtype`` is the pyramid's (bf16 as the configuration states:
convolutions, bias, ReLU and L2 pools in bf16), statistics in fp32.
``lower=True`` is the control one step below the stated precision: every
convolution's input and weight rounded to fp8 (e4m3, one scale a tensor
from its largest magnitude, as an fp8 convolution takes them) before the
bf16 convolution.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STAGE_CONVS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
STAGE_POOL = {2: 4, 3: 9, 4: 16, 5: 23}
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8_e4m3fn with one scale for the tensor (its largest
    magnitude maps to the format's largest value), back in x's dtype; the
    gradient passes straight through the rounding."""
    with torch.no_grad():
        amax = x.abs().amax().float().clamp_min(1e-12)
        scale = FP8_MAX / amax
        q = (x.float() * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
        q = (q.float() / scale).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, dtype,
         lower: bool, **kw) -> torch.Tensor:
    """A convolution in ``dtype`` (its bias added in ``dtype``); with
    ``lower`` its operands rounded to fp8 first."""
    x, w = x.to(dtype), w.to(dtype)
    if lower:
        x, w = fp8_round(x), fp8_round(w)
    y = F.conv2d(x, w, None, **kw)
    return y if b is None else y + b.to(dtype).view(1, -1, 1, 1)


def hann3(channels: int, device) -> torch.Tensor:
    a = np.hanning(5)[1:-1]
    win = np.outer(a, a)
    win = torch.tensor(win / win.sum(), dtype=torch.float32, device=device)
    return win[None, None].repeat(channels, 1, 1, 1)


def l2pool(x: torch.Tensor) -> torch.Tensor:
    """sqrt(Hann-filtered x² + 1e-12), stride 2, padding 1, in x's dtype."""
    c = x.shape[1]
    y = F.conv2d(x * x, hann3(c, x.device).to(x.dtype), stride=2, padding=1,
                 groups=c)
    return (y + 1e-12).sqrt()


def pyramid(state: dict, x: torch.Tensor, dtype=torch.bfloat16,
            lower: bool = False) -> list[torch.Tensor]:
    """NCHW images in [0, 1] -> the six NCHW feature levels in ``dtype``."""
    mean = torch.tensor([0.485, 0.456, 0.406], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=x.device).view(1, 3, 1, 1)
    feats = [x.to(dtype)]
    h = (x.float() - mean) / std
    for si, idxs in enumerate(STAGE_CONVS, start=1):
        if si > 1:
            h = l2pool(h)
        for idx in idxs:
            h = conv(h, state[f"stage{si}.{idx}.weight"], state[f"stage{si}.{idx}.bias"],
                     dtype, lower, padding=1).relu()
        feats.append(h)
    return feats


def alpha_beta(path: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The published α, β from their .npz, divided by their joint sum."""
    data = np.load(path)
    a = torch.tensor(data["alpha"], dtype=torch.float32, device=device).reshape(-1)
    b = torch.tensor(data["beta"], dtype=torch.float32, device=device).reshape(-1)
    s = a.sum() + b.sum()
    return a / s, b / s


def stats(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    f = f.float()
    m = f.mean((2, 3))
    return m, (f - m[..., None, None]).square().mean((2, 3))


def score_feats(f0: list, f1: list, alpha: torch.Tensor, beta: torch.Tensor,
                c1: float = 1e-6, c2: float = 1e-6) -> torch.Tensor:
    """DISTS of two NCHW pyramids, per image."""
    s1s, s2s = [], []
    for a, b in zip(f0, f1):
        mx, vx = stats(a)
        my, vy = stats(b)
        cov = (a.float() * b.float()).mean((2, 3)) - mx * my
        s1s.append((2 * mx * my + c1) / (mx * mx + my * my + c1))
        s2s.append((2 * cov + c2) / (vx + vy + c2))
    s1 = torch.cat(s1s, dim=1)
    s2 = torch.cat(s2s, dim=1)
    return 1.0 - (alpha * s1 + beta * s2).sum(1)


def frames_to_unit(frames: torch.Tensor, size) -> torch.Tensor:
    """uint8 (0-255) or float ([0, 1]) NHWC frames -> fp32 NCHW in [0, 1],
    resized to ``size``."""
    x = frames.permute(0, 3, 1, 2).float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    if size is not None and tuple(x.shape[2:]) != tuple(size):
        x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
    return x


@torch.no_grad()
def score_frames(state: dict, alpha, beta, dist: torch.Tensor, ref: torch.Tensor,
                 size, dtype=torch.bfloat16, lower: bool = False,
                 block: int = 8) -> torch.Tensor:
    """DISTS(dist, ref) of NHWC frame pairs (uint8, or float in [0, 1]),
    ``block`` pairs at a time; fp32 scores on the frames' device."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for lo in range(0, dist.shape[0], block):
            x = frames_to_unit(dist[lo:lo + block], size)
            y = frames_to_unit(ref[lo:lo + block], size)
            out.append(score_feats(pyramid(state, x, dtype, lower),
                                   pyramid(state, y, dtype, lower), alpha, beta))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
