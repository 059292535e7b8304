"""DISTS perceptual metric in PyTorch.

Counterpart of ``nerf_qa_tpu/core/dists.py``. Reference behaviour:
DISTS_pt.py:27-208 (main), DISTS_pt_original.py:30-138 ('original' weight
norm modes), DISTS_pt_softmax.py ('softmax' logits).

score = 1 - Σₖ Σ_c (αₖ_c·S1ₖ_c + βₖ_c·S2ₖ_c) over the 6 pyramid levels,
where per channel c of stage k:
  S1 = (2·x̄·ȳ + c1) / (x̄² + ȳ² + c1)                (texture)
  S2 = (2·cov + c2) / (var_x + var_y + c2)            (structure)
with spatial means/variances/covariance over H×W (DISTS_pt.py:130-148).

Statistics: ``stats_impl='eager'`` is the two-pass oracle
(``stage_stats_eager``, the counterpart of ``stage_stats_xla``);
``stats_impl='kernel'`` sends every stage to the fused CUDA moments kernel
(``ops/cuda/moments.py``). The JAX package sent only stages of C ≥ 64 and
≥ 1M pixels to its Pallas kernel, a crossover measured on a TPU; the port
keeps no such threshold.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from nerf_qa_torch.config import DISTSConfig, torch_dtype
from nerf_qa_torch.core.vgg import PYRAMID_CHANNELS, VGG16Pyramid
from nerf_qa_torch.utils.profiling import span

TOTAL_CHANNELS = sum(PYRAMID_CHANNELS)  # 1475

_ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "dists_alpha_beta.npz",
)


class DISTSWeights(NamedTuple):
    """Learnable perceptual weights, flat (1475,) each. For
    variant='softmax' these are logits (DISTS_pt_softmax.py:70-78)."""

    alpha: torch.Tensor
    beta: torch.Tensor

    def to(self, device) -> "DISTSWeights":
        return DISTSWeights(self.alpha.to(device), self.beta.to(device))


def load_pretrained_weights(cfg: DISTSConfig = DISTSConfig(),
                            path: str | None = None) -> DISTSWeights:
    """The bundled pretrained α/β (the reference's weights.pt, converted),
    with the variant's load-time transform."""
    data = np.load(path or _ASSET_PATH)
    return weights_from_arrays(data["alpha"], data["beta"], cfg)


def weights_from_arrays(alpha, beta,
                        cfg: DISTSConfig = DISTSConfig()) -> DISTSWeights:
    """DISTSWeights from raw α/β arrays. variant='original' clamps to
    (lb·ratio, lb) (DISTS_pt_original.py:69-72); variant='softmax' stores
    log(clamp(w, 0) + 1e-10) logits (DISTS_pt_softmax.py:70-78)."""
    alpha = np.asarray(alpha, np.float32).reshape(-1)
    beta = np.asarray(beta, np.float32).reshape(-1)
    if cfg.variant == "original":
        lb = cfg.weight_lower_bound
        alpha = np.maximum(alpha, lb * cfg.alpha_beta_ratio)
        beta = np.maximum(beta, lb)
    elif cfg.variant == "softmax":
        alpha = np.log(np.maximum(alpha, 0.0) + 1e-10)
        beta = np.log(np.maximum(beta, 0.0) + 1e-10)
    return DISTSWeights(torch.from_numpy(alpha.astype(np.float32)),
                        torch.from_numpy(beta.astype(np.float32)))


def init_random_weights(seed: int = 0) -> DISTSWeights:
    """Normal(0.1, 0.01) init (DISTS_pt.py:60-61) from a numpy seed: the
    same numbers as the JAX package's ``init_random_weights``."""
    rng = np.random.default_rng(seed)
    return DISTSWeights(
        torch.from_numpy(rng.normal(0.1, 0.01, TOTAL_CHANNELS).astype(np.float32)),
        torch.from_numpy(rng.normal(0.1, 0.01, TOTAL_CHANNELS).astype(np.float32)),
    )


def normalized_alpha_beta(w: DISTSWeights, cfg: DISTSConfig):
    """Forward-time weight normalisation for every variant.

    main:      α/Σ(α,β), β/Σ(α,β)                  (DISTS_pt.py:127-129)
    original:  optional relu, optional detached sum (DISTS_pt_original.py:111-121)
    softmax:   softmax over concat(α,β)             (DISTS_pt_softmax.py:117-121)
    """
    alpha, beta = w.alpha, w.beta
    if cfg.variant == "softmax":
        joint = torch.softmax(torch.cat([alpha, beta]), dim=0)
        alpha, beta = joint[:TOTAL_CHANNELS], joint[TOTAL_CHANNELS:]
    else:
        tokens = cfg.weight_norm.split("+") if cfg.weight_norm else []
        if "relu" in tokens:
            alpha = torch.relu(alpha)
            beta = torch.relu(beta)
        w_sum = alpha.sum() + beta.sum()
        if "w_sum_detach" in tokens:
            w_sum = w_sum.detach()
        alpha = alpha / w_sum
        beta = beta / w_sum
    if cfg.detach_beta:
        beta = beta.detach()
    return alpha, beta


def project_weights(w: DISTSWeights, cfg: DISTSConfig) -> DISTSWeights:
    """Non-negativity projection applied after optimizer steps.

    main/softmax: floor 0 with a 0.02 floor on the 3 RGB channels
    (DISTS_pt.py:82-89). original: floor = weight_lower_bound, α floor
    scaled by alpha_beta_ratio (DISTS_pt_original.py:88-95). Renormalises
    by the joint sum.
    """
    with torch.no_grad():
        if cfg.variant == "original":
            lb = torch.full((TOTAL_CHANNELS,), cfg.weight_lower_bound,
                            device=w.alpha.device)
            alpha = torch.maximum(w.alpha, lb * cfg.alpha_beta_ratio)
            beta = torch.maximum(w.beta, lb)
        else:
            lb = torch.zeros((TOTAL_CHANNELS,), device=w.alpha.device)
            lb[:3] = 0.02
            alpha = torch.maximum(w.alpha, lb)
            beta = torch.maximum(w.beta, lb)
        w_sum = alpha.sum() + beta.sum()
        return DISTSWeights(alpha / w_sum, beta / w_sum)


class StageStats(NamedTuple):
    """Per-stage spatial statistics, each (N, C) fp32."""

    mean_x: torch.Tensor
    mean_y: torch.Tensor
    var_x: torch.Tensor
    var_y: torch.Tensor
    cov_xy: torch.Tensor


def stage_stats_eager(fx: torch.Tensor, fy: torch.Tensor) -> StageStats:
    """Spatial moments of one NHWC feature stage -> (N, C) each, in the
    torch reduction order (two-pass variance, E[xy] - x̄·ȳ covariance;
    DISTS_pt.py:131-139). bf16 features upcast to fp32."""
    fx = fx.float()
    fy = fy.float()
    dims = (1, 2)
    mean_x = fx.mean(dims)
    mean_y = fy.mean(dims)
    var_x = (fx - mean_x[:, None, None, :]).square().mean(dims)
    var_y = (fy - mean_y[:, None, None, :]).square().mean(dims)
    cov = (fx * fy).mean(dims) - mean_x * mean_y
    return StageStats(mean_x, mean_y, var_x, var_y, cov)


def pyramid_stats(feats0: Sequence[torch.Tensor], feats1: Sequence[torch.Tensor],
                  cfg: DISTSConfig = DISTSConfig()) -> torch.Tensor:
    """All six stages' statistics, concatenated over channels: a
    (5, N, 1475) tensor [mean_x, mean_y, var_x, var_y, cov], in the span
    ``dists.stats`` with n, h, w, c and itemsize of each of ``feats0``."""
    if cfg.stats_impl == "kernel":
        from nerf_qa_torch.ops.cuda.moments import stage_stats_kernel

        stats_fn = stage_stats_kernel
    elif cfg.stats_impl == "eager":
        stats_fn = stage_stats_eager
    else:
        raise ValueError(f"stats_impl must be 'eager' or 'kernel', got "
                         f"{cfg.stats_impl!r}")
    with span("dists.stats", lambda: [v for f in feats0
                                      for v in (*f.shape, f.element_size())]):
        per_stage = [stats_fn(fx, fy) for fx, fy in zip(feats0, feats1)]
        return torch.stack(
            [torch.cat([s[i] for s in per_stage], dim=-1) for i in range(5)]
        )


def score_from_stats(stats: torch.Tensor, w: DISTSWeights,
                     cfg: DISTSConfig = DISTSConfig()) -> torch.Tensor:
    """DISTS score from pooled statistics: (5, N, 1475) -> (N,)."""
    mean_x, mean_y, var_x, var_y, cov = stats
    alpha, beta = normalized_alpha_beta(w, cfg)
    s1 = (2.0 * mean_x * mean_y + cfg.c1) / (
        mean_x.square() + mean_y.square() + cfg.c1
    )
    s2 = (2.0 * cov + cfg.c2) / (var_x + var_y + cfg.c2)
    dist = (alpha * s1 + beta * s2).sum(dim=-1)
    return 1.0 - dist


def score_from_feats(
    w: DISTSWeights,
    feats0: Sequence[torch.Tensor],
    feats1: Sequence[torch.Tensor],
    cfg: DISTSConfig = DISTSConfig(),
    batch_average: bool = False,
) -> torch.Tensor:
    """Score two precomputed NHWC feature pyramids (DISTS_pt.py:181-208)."""
    score = score_from_stats(pyramid_stats(feats0, feats1, cfg), w, cfg)
    return score.mean() if batch_average else score


def forward(
    model: VGG16Pyramid,
    w: DISTSWeights,
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: DISTSConfig = DISTSConfig(),
    batch_average: bool = False,
    stop_feature_grad: bool = True,
) -> torch.Tensor:
    """Full DISTS forward on NHWC image batches in [0, 1]
    (DISTS_pt.py:105-148). Both images go through the pyramid as one
    batch. ``stop_feature_grad`` mirrors the reference's no_grad feature
    extraction; the gradient to α/β comes from autograd through
    ``score_from_stats``."""
    if x.shape != y.shape:
        raise ValueError(
            f"DISTS requires identically shaped inputs, got {tuple(x.shape)} "
            f"vs {tuple(y.shape)}"
        )
    n = x.shape[0]
    dtype = torch_dtype(cfg.compute_dtype)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_feature_grad):
        both = model(torch.cat([x, y]), dtype)
    feats0 = [f[:n] for f in both]
    feats1 = [f[n:] for f in both]
    return score_from_feats(w, feats0, feats1, cfg, batch_average)


def forward_once(model: VGG16Pyramid, x: torch.Tensor,
                 cfg: DISTSConfig = DISTSConfig()) -> list[torch.Tensor]:
    """Feature pyramid of one image batch (DISTS_pt.py:91-103)."""
    return model(x, torch_dtype(cfg.compute_dtype))


class DISTS(VGG16Pyramid):
    """The reference DISTS module: the frozen pyramid plus learnable
    ``alpha`` / ``beta`` of shape (1, 1475, 1, 1), in the reference
    ``state_dict`` layout (DISTS_pt.py:27-80; the ``dists_model.*`` keys
    of a reference FR ``model.pth``)."""

    def __init__(self, weights: DISTSWeights | None = None,
                 cfg: DISTSConfig = DISTSConfig()):
        super().__init__()
        w = weights if weights is not None else init_random_weights()
        self.alpha = nn.Parameter(w.alpha.detach().clone().reshape(1, -1, 1, 1))
        self.beta = nn.Parameter(w.beta.detach().clone().reshape(1, -1, 1, 1))
        self.cfg = cfg

    def weights(self) -> DISTSWeights:
        return DISTSWeights(self.alpha.reshape(-1), self.beta.reshape(-1))

    def score(self, x: torch.Tensor, y: torch.Tensor,
              batch_average: bool = False) -> torch.Tensor:
        """DISTS of NHWC batches in [0, 1] with this module's weights."""
        return forward(self, self.weights(), x, y, self.cfg, batch_average)
