"""Correlation metrics and scene-level aggregation.

Counterpart of ``nerf_qa_tpu/eval/correlations.py`` (a copy). Reference
behavior: nerf_qa/logger.py:93-102 (PLCC/SRCC/KTCC via scipy),
:204-267 (per-scene / scene-type subsets, scene_min/scene_mean absolute
correlations), :284-302 (combined_score sweep objective with hard-coded
reference correlations).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
from scipy.stats import kendalltau, pearsonr, spearmanr

# Scene-type partition of the NeRF-QA benchmark (logger.py:209-210).
REAL_SCENE_IDS = (
    "train", "m60", "playground", "truck", "fortress", "horns", "trex", "room",
)
SYNTH_SCENE_IDS = (
    "ship", "lego", "drums", "ficus", "hotdog", "materials", "mic", "chair",
)


def compute_correlations(pred: np.ndarray, target: np.ndarray) -> dict[str, float]:
    """{'plcc','srcc','ktcc'} (logger.py:93-102)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return {
        "plcc": float(pearsonr(pred, target)[0]),
        "srcc": float(spearmanr(pred, target)[0]),
        "ktcc": float(kendalltau(pred, target)[0]),
    }


def scene_grouped_correlations(
    pred_by_video: Mapping,
    target_by_video: Mapping,
    scene_by_video: Mapping,
    real_scenes: Sequence[str] = REAL_SCENE_IDS,
    synth_scenes: Sequence[str] = SYNTH_SCENE_IDS,
) -> dict:
    """Full correlation report over per-video scores.

    Returns: overall / real / synthetic correlations, per-scene
    correlations, and scene_min / scene_mean absolute-correlation
    aggregates (overall + per scene type), mirroring
    logger.log_correlations (logger.py:205-267).
    """
    videos = list(pred_by_video.keys())
    scenes: dict[str, list] = {}
    for vid in videos:
        scenes.setdefault(scene_by_video[vid], []).append(vid)

    out: dict = {"per_scene": {}}
    agg = {"plcc": [], "srcc": [], "ktcc": []}
    real_agg = {"plcc": [], "srcc": [], "ktcc": []}
    synth_agg = {"plcc": [], "srcc": [], "ktcc": []}
    real_pred, real_tgt, synth_pred, synth_tgt = [], [], [], []

    for sid, vids in scenes.items():
        p = np.array([pred_by_video[v] for v in vids], np.float64)
        t = np.array([target_by_video[v] for v in vids], np.float64)
        if len(vids) > 1:
            corr = compute_correlations(p, t)
            out["per_scene"][sid] = corr
            for m, v in corr.items():
                agg[m].append(abs(v))
                (real_agg if sid in real_scenes else synth_agg)[m].append(abs(v))
        if sid in real_scenes:
            real_pred.append(p)
            real_tgt.append(t)
        elif sid in synth_scenes:
            synth_pred.append(p)
            synth_tgt.append(t)

    if len(real_pred) > 1:
        out["real"] = compute_correlations(
            np.concatenate(real_pred), np.concatenate(real_tgt)
        )
    if len(synth_pred) > 1:
        out["synthetic"] = compute_correlations(
            np.concatenate(synth_pred), np.concatenate(synth_tgt)
        )
    if agg["plcc"]:
        out["scene_min"] = {m: float(np.min(v)) for m, v in agg.items()}
        out["scene_mean"] = {m: float(np.mean(v)) for m, v in agg.items()}
    if real_agg["plcc"]:
        out["real_scene_mean"] = {m: float(np.mean(v)) for m, v in real_agg.items()}
    if synth_agg["plcc"]:
        out["synth_scene_mean"] = {m: float(np.mean(v)) for m, v in synth_agg.items()}
    if len(videos) > 1:
        out["overall"] = compute_correlations(
            np.array([pred_by_video[v] for v in videos]),
            np.array([target_by_video[v] for v in videos]),
        )
    return out


# combined_score reference values + direction (logger.py:284-301):
# (report key path, low reference, high target)
_COMBINED_TERMS = (
    (("scene_mean", "plcc"), 0.9337, 1.0),
    (("scene_mean", "srcc"), 0.9268, 1.0),
    (("real_scene_mean", "plcc"), 0.9556, 1.0),
    (("real_scene_mean", "srcc"), 0.9429, 1.0),
    (("synth_scene_mean", "plcc"), 0.9117, 1.0),
    (("synth_scene_mean", "srcc"), 0.9107, 1.0),
    (("overall", "plcc"), -0.878, -1.0),
    (("overall", "srcc"), -0.9149, -1.0),
    (("real", "plcc"), -0.9081, -1.0),
    (("real", "srcc"), -0.9395, -1.0),
    (("synthetic", "plcc"), -0.8971, -1.0),
    (("synthetic", "srcc"), -0.9139, -1.0),
)


def combined_score(report: dict, tol: float = 0.05) -> float:
    """Sweep objective: sum of scaled correlation improvements over the
    best-known reference values, with a 120x penalty below reference
    (logger.py:284-302). Positive-direction terms get the tolerance
    slack; negative (raw-correlation) terms do not — exactly as the
    reference computes it."""
    total = 0.0
    for (section, metric), low, high in _COMBINED_TERMS:
        value = report.get(section, {}).get(metric)
        if value is None:
            continue
        lo = low - tol if high > 0 else low
        x = (value - lo) / (high - lo)
        total += 120.0 * x if x < 0 else x
    return float(total)
