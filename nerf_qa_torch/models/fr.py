"""Full-reference MOS-regression models.

Counterpart of ``nerf_qa_tpu/models/fr.py``. Reference behavior:
nerf_qa/model.py:22-56 (simple linear/sqrt heads) and
nerf_qa/model_stats.py:23-102 (logistic/sqrt/linear heads, entropy
regularization, MOS/DMOS target selection), plus the per-param-group
learning rates and dataloader-level video scoring that five reference
training scripts call but whose implementations were never checked in (SURVEY §2
#7 version-skew note).

The model is a plain function of an explicit param structure
  {'head': {name: tensor}, 'dists': DISTSWeights}
of leaf tensors, so the trainer's optimizer sees two parameter groups
(``param_labels``) and ``forward_from_stats`` stays a function of
tensors. The head init runs on the host in float64 numpy (scipy's
``curve_fit`` for the logistic head), as the JAX package's does.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from nerf_qa_torch.config import FRModelConfig, torch_dtype
from nerf_qa_torch.core import dists
from nerf_qa_torch.utils.profiling import span


def _logistic_np(x, b1, b2, b3, b4, sign):
    return (b1 - b2) / (1 + np.exp(sign * (x - b3) / np.abs(b4))) + b2


def _param(v) -> torch.Tensor:
    return torch.tensor([float(v)], dtype=torch.float32)


def init_head_params(
    train_dists_scores: np.ndarray,
    train_targets: np.ndarray,
    cfg: FRModelConfig = FRModelConfig(),
) -> dict[str, torch.Tensor]:
    """Data-driven head init, matching the reference:

    * logistic: scipy curve_fit of the 4-parameter logistic
      (model_stats.py:33-48), initial guesses from target extrema /
      predictor median+std.
    * sqrt/linear: least-squares line fit (model.py:26-47 uses sklearn
      LinearRegression; plain lstsq is numerically identical).
    """
    x = np.asarray(train_dists_scores, np.float64)
    y = np.asarray(train_targets, np.float64)
    if cfg.regression_type == "logistic":
        from scipy.optimize import curve_fit

        sign = 1.0 if cfg.subjective_score_type == "MOS" else -1.0
        is_mos = cfg.subjective_score_type == "MOS"
        # floor the slope-scale guess/result: near-constant predictors
        # (tiny std) otherwise drive curve_fit to |b4|→0, a step-function
        # head whose gradients vanish everywhere — training never recovers
        b4_floor = max(1e-3 * (np.std(x) + abs(np.median(x))), 1e-6)
        p0 = [
            np.max(y) if is_mos else np.min(y),
            np.min(y) if is_mos else np.max(y),
            np.median(x),
            max(np.std(x), b4_floor),
        ]
        params, _ = curve_fit(
            lambda x, b1, b2, b3, b4: _logistic_np(x, b1, b2, b3, b4, sign),
            x, y, p0=p0, maxfev=20000,
        )
        params[3] = np.sign(params[3] or 1.0) * max(abs(params[3]), b4_floor)
        return {f"b{i + 1}": _param(v) for i, v in enumerate(params)}
    if cfg.regression_type == "sqrt":
        x = np.sqrt(x)
    a = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return {"weight": _param(coef[0]), "bias": _param(coef[1])}


def init_params(
    train_dists_scores: np.ndarray,
    train_targets: np.ndarray,
    cfg: FRModelConfig = FRModelConfig(),
    dists_weights: dists.DISTSWeights | None = None,
    n_stats: int = 0,
    n_scene_types: int = 0,
) -> dict[str, Any]:
    """Full trainable structure: regression head + DISTS α/β (+ optional
    video-stats head extension, run_test2_stats.py:122-135; + optional
    scene-type calibration, run_test2.py:218). Fresh CPU tensors."""
    head = init_head_params(train_dists_scores, train_targets, cfg)
    if n_stats > 0:
        head.update(init_stats_head(n_stats))
    if n_scene_types > 0:
        head.update(init_scene_type_head(n_scene_types))
    w = (dists_weights if dists_weights is not None
         else dists.load_pretrained_weights(cfg.dists))
    return {"head": head,
            "dists": dists.DISTSWeights(w.alpha.detach().clone().cpu(),
                                        w.beta.detach().clone().cpu())}


def apply_head(head: dict[str, torch.Tensor], dists_scores: torch.Tensor,
               cfg: FRModelConfig) -> torch.Tensor:
    """Regression head (model_stats.py:71-79)."""
    if cfg.regression_type == "logistic":
        sign = 1.0 if cfg.subjective_score_type == "MOS" else -1.0
        b1, b2, b3, b4 = head["b1"], head["b2"], head["b3"], head["b4"]
        # sigmoid(-z) == 1/(1+exp(z)) but saturates without inf: the
        # naive exp form yields inf/inf = NaN *gradients* once a fold's
        # curve_fit lands on a tiny |b4| (near-constant predictor), which
        # silently NaNs the whole fold after one optimizer step
        z = sign * (dists_scores - b3) / b4.abs()
        return (b1 - b2) * torch.sigmoid(-z) + b2
    if cfg.regression_type == "sqrt":
        return dists_scores.sqrt() * head["weight"] + head["bias"]
    return dists_scores * head["weight"] + head["bias"]


def forward(
    params: dict[str, Any],
    vgg: torch.nn.Module,
    dist_imgs: torch.Tensor,
    ref_imgs: torch.Tensor,
    cfg: FRModelConfig = FRModelConfig(),
    stats: torch.Tensor | None = None,
    scene_types: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mos_pred, dists_score) for NHWC image batches
    (model_stats.py:92-102). ``stats``: optional (N, n_stats) per-video
    DISTS statistics features (run_test2_stats.py:195). ``scene_types``:
    optional (N,) int ids conditioning a per-type calibration
    (run_test2.py:218). The pyramid is frozen (no feature gradients)."""
    dists_scores = dists.forward(vgg, params["dists"], dist_imgs, ref_imgs,
                                 cfg.dists)
    pred = apply_head_with_stats(params["head"], dists_scores, stats, cfg)
    pred = apply_scene_type(params["head"], pred, scene_types)
    return pred, dists_scores


def pair_stats(vgg: torch.nn.Module, dist_imgs: torch.Tensor,
               ref_imgs: torch.Tensor, cfg: FRModelConfig = FRModelConfig()
               ) -> torch.Tensor:
    """(5, N, 1475) pooled moments of (dist, ref) image batches, both sent
    through the frozen pyramid as one batch: the cacheable half of
    ``forward`` (``dists.forward`` up to ``score_from_stats``), in the
    profiler ranges ``fr.pyramid`` and ``fr.stats``."""
    n = dist_imgs.shape[0]
    with torch.no_grad():
        with span("fr.pyramid"):
            both = vgg(torch.cat([dist_imgs, ref_imgs]),
                       torch_dtype(cfg.dists.compute_dtype))
        with span("fr.stats"):
            return dists.pyramid_stats([f[:n] for f in both],
                                       [f[n:] for f in both], cfg.dists)


def forward_from_stats(
    params: dict[str, Any],
    stats_5nc: torch.Tensor,
    cfg: FRModelConfig = FRModelConfig(),
    stats: torch.Tensor | None = None,
    scene_types: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mos_pred, dists_score) from precomputed pair statistics.

    ``stats_5nc``: (5, N, 1475) pooled moments from ``pair_stats`` — the
    frozen-VGG part of the metric. FR training only updates α/β and the
    regression head, and the DISTS score is (statistics ∘ frozen pyramid)
    followed by the α/β-weighted similarity (DISTS_pt.py:122-148), so the
    expensive half can be computed once per frame pair and reused every
    epoch. Gradients w.r.t. α/β and the head are exact; the reference
    re-runs both VGG16 passes every step (run_final.py:189)."""
    dists_scores = dists.score_from_stats(stats_5nc, params["dists"], cfg.dists)
    pred = apply_head_with_stats(params["head"], dists_scores, stats, cfg)
    pred = apply_scene_type(params["head"], pred, scene_types)
    return pred, dists_scores


def entropy_loss(
    params: dict[str, Any],
    original: dists.DISTSWeights,
    cfg: FRModelConfig = FRModelConfig(),
) -> torch.Tensor:
    """Cross-entropy of learned α/β against the pretrained distribution
    (model_stats.py:81-90)."""
    w = params["dists"]
    weights = torch.cat([w.alpha, w.beta])
    norm = cfg.dists.weight_norm
    if cfg.dists.variant == "softmax":
        weights = torch.softmax(weights, dim=0)
    else:
        if "relu" in (norm.split("+") if norm else []):
            weights = torch.relu(weights)
        weights = weights / weights.sum()
    orig = torch.cat([original.alpha, original.beta]).to(weights.device)
    return -(orig * torch.log(weights + 1e-10)).sum()


def init_stats_head(n_stats: int = 3) -> dict[str, torch.Tensor]:
    """Video-statistics-conditioned head extension (run_test2_stats.py:
    122-135,195 feeds per-video DISTS std/min/max alongside the frame
    score): a zero-initialized linear term over the stats features added
    to the base regression output."""
    return {"stats_weight": torch.zeros((n_stats,), dtype=torch.float32)}


def apply_head_with_stats(
    head: dict[str, torch.Tensor],
    dists_scores: torch.Tensor,
    stats: torch.Tensor | None,
    cfg: FRModelConfig,
) -> torch.Tensor:
    """Regression head with optional per-video stats features.

    stats: (N, n_stats) — e.g. [DISTS_std, DISTS_min, DISTS_max] gathered
    per frame's video. None falls back to the plain head."""
    base = apply_head(head, dists_scores, cfg)
    if stats is None or "stats_weight" not in head:
        return base
    return base + stats @ head["stats_weight"]


def init_scene_type_head(n_scene_types: int = 2) -> dict[str, torch.Tensor]:
    """Scene-type-conditioned calibration head. run_test2.py:218 passes
    ``scene_type=`` into a model version that was never checked in
    (SURVEY §2 #7 version-skew note); the superset interface is a
    per-type affine on the regression output, identity-initialized so
    enabling it is behavior-preserving until trained."""
    return {
        "scene_scale": torch.ones((n_scene_types,), dtype=torch.float32),
        "scene_bias": torch.zeros((n_scene_types,), dtype=torch.float32),
    }


def apply_scene_type(
    head: dict[str, torch.Tensor],
    pred: torch.Tensor,
    scene_types: torch.Tensor | None,
) -> torch.Tensor:
    """Per-scene-type affine calibration of head output; (N,) int ids
    gather the type's (scale, bias). None falls back to the plain head,
    and so does any NEGATIVE id (the "no conditioning" sentinel the
    trainer passes when it has no ids — without it, a scene-conditioned
    checkpoint evaluated without ids would silently get the trained
    type-0 affine applied to every sample)."""
    if scene_types is None or "scene_scale" not in head:
        return pred
    st = scene_types.long()
    idx = st.clamp(min=0)
    calibrated = pred * head["scene_scale"][idx] + head["scene_bias"][idx]
    return torch.where(st >= 0, calibrated, pred)


def param_labels(params: dict[str, Any]) -> dict[str, list[torch.Tensor]]:
    """Optimizer param groups — the ``get_param_lr`` superset
    (run_test2_cross.py:151 calls it; never checked in): 'head' params
    typically train with a larger LR than the DISTS α/β."""
    return {"head": list(params["head"].values()),
            "dists": [params["dists"].alpha, params["dists"].beta]}


def params_state(params: dict[str, Any]) -> dict[str, dict[str, torch.Tensor]]:
    """Plain nested dicts of detached CPU tensors (what a checkpoint
    stores: ``torch.load(weights_only=True)`` reads them back)."""
    return {"head": {k: v.detach().cpu() for k, v in params["head"].items()},
            "dists": {"alpha": params["dists"].alpha.detach().cpu(),
                      "beta": params["dists"].beta.detach().cpu()}}


def params_from_state(state: dict[str, Any]) -> dict[str, Any]:
    """Inverse of ``params_state``."""
    d = state["dists"]
    return {"head": {k: torch.as_tensor(v).float() for k, v in state["head"].items()},
            "dists": dists.DISTSWeights(torch.as_tensor(d["alpha"]).float(),
                                        torch.as_tensor(d["beta"]).float())}
