"""Metric collection + frame->video->scene aggregation.

Counterpart of ``nerf_qa_tpu/logging/metrics.py``. Reference behavior:
nerf_qa/logger.py:62-315 (``MetricCollectionLogger``): accumulate
per-batch metric arrays tagged with video/scene ids; on ``log_summary``
aggregate frame->video means (plus rmse from mse), video->scene means,
log per-key/per-video/per-scene scalars, compute the full correlation
report vs MOS (and optionally DMOS) and the ``combined_score`` sweep
objective; then reset. ``MetricAggregator`` is train-nr.py:98-140's
running-mean loss logger.

Sinks are pluggable: a JSONL file, or wandb when it is importable (a
no-op artifact shim otherwise). The per-video table is written with the
``csv`` module in the layout of the JAX package's ``video_metrics_df().
to_csv()``.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Callable, Mapping

import numpy as np

from nerf_qa_torch.eval.correlations import (
    combined_score,
    scene_grouped_correlations,
)


def jsonl_sink(path: str) -> Callable:
    """A log function that appends ``{"step": step, **scalars}`` to
    ``path`` as one JSON line per call."""
    def log_fn(logs: Mapping, step: int) -> None:
        record = {"step": step}
        record.update(
            {k: v for k, v in logs.items() if isinstance(v, (int, float, str))}
        )
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    return log_fn


def wandb_sink():
    import wandb

    return lambda logs, step: wandb.log(dict(logs), step=step)


def log_artifact(path: str, name: str | None = None,
                 type: str = "results") -> bool:
    """wandb.Artifact upload shim (run_final.py:279-287,328-336 pushes
    results CSVs and model files as Artifacts). Uploads when wandb is
    importable AND a run is active; otherwise a no-op — the files
    already live in the local run dir. Returns True when uploaded."""
    try:
        import wandb
    except ImportError:
        return False
    if getattr(wandb, "run", None) is None:
        return False
    artifact = wandb.Artifact(
        name or os.path.basename(path).replace(".", "-"), type=type
    )
    if os.path.isdir(path):
        artifact.add_dir(path)
    else:
        artifact.add_file(path)
    wandb.run.log_artifact(artifact)
    return True


class MetricCollectionLogger:
    """Drop-in equivalent of the reference logger (logger.py:62)."""

    def __init__(self, collection_name: str, log_fn: Callable | None = None):
        self.collection_name = collection_name
        self.log_fn = log_fn or (lambda logs, step: None)
        self.last_correlations: dict = {}
        self.last_mse: float | None = None
        self.last_loss: float | None = None
        self.last_logs: dict = {}
        self._reset()

    def _reset(self) -> None:
        self.metrics: dict[str, list[np.ndarray]] = {}
        self.video_ids: list[np.ndarray] = []
        self.scene_ids: list[np.ndarray] = []

    def add_entries(self, metrics: Mapping, video_ids, scene_ids) -> None:
        """Append per-frame metric values tagged by video and scene
        (logger.py:74-91). Scalars are promoted to length-1 arrays."""
        self.video_ids.append(np.atleast_1d(np.asarray(video_ids)))
        self.scene_ids.append(np.atleast_1d(np.asarray(scene_ids)))
        for key, value in metrics.items():
            self.metrics.setdefault(key, []).append(
                np.atleast_1d(np.asarray(value))
            )

    def _video_averages(self):
        metrics = {k: np.concatenate(v) for k, v in self.metrics.items()}
        video_ids = np.concatenate(self.video_ids)
        scene_ids = np.concatenate(self.scene_ids)
        unique_videos = np.unique(video_ids)
        keys = list(metrics.keys())
        video_averages: dict[str, dict] = {k: {} for k in keys}
        scene_of_video: dict = {}
        for vid in unique_videos:
            mask = video_ids == vid
            for k in keys:
                video_averages[k][vid] = float(np.mean(metrics[k][mask]))
            scene_of_video[vid] = scene_ids[mask][0]
        if "mse" in video_averages:
            video_averages["rmse"] = {
                vid: float(np.sqrt(v)) for vid, v in video_averages["mse"].items()
            }
        return video_averages, unique_videos, scene_of_video

    def per_scene_figure(self, x_key: str = "pred_score",
                         y_key: str = "mos") -> dict:
        """Plotly-schema per-scene regression figure of the current
        accumulation (logger.py:36-59,207 — the figure the reference
        logged to wandb on every eval pass). Pure JSON dict; see
        logging/figures.py for sinks."""
        from nerf_qa_torch.logging.figures import per_scene_regression_figure

        video_averages, _, scene_of_video = self._video_averages()
        return per_scene_regression_figure(
            video_averages.get(x_key, {}), video_averages.get(y_key, {}),
            scene_of_video, x_title=x_key, y_title=y_key,
            title=f"{self.collection_name}: per-scene regression",
        )

    def write_video_metrics_csv(self, path: str) -> str:
        """Per-video metric means as a CSV (logger.py:104-141), the
        results.csv export path: a ``video_id`` column, then one column
        per metric, one row per video in id order — the JAX package's
        ``video_metrics_df().to_csv(path)``."""
        video_averages, unique_videos, _ = self._video_averages()
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["video_id", *video_averages])
            for vid in unique_videos:
                writer.writerow([vid.item(), *(repr(v[vid]) for v in video_averages.values())])
        return path

    def log_summary(self, step: int) -> dict:
        """Aggregate, log, and reset (logger.py:144-315). Returns the flat
        log dict (also kept as ``last_logs`` for tests/sweeps)."""
        logs: dict = {}
        name = self.collection_name
        video_averages, unique_videos, scene_of_video = self._video_averages()
        unique_scenes = np.unique(
            np.array([scene_of_video[v] for v in unique_videos])
        )
        scene_averages: dict[str, dict] = {}
        for key, per_video in video_averages.items():
            scene_averages[key] = {}
            for sid in unique_scenes:
                vals = [per_video[v] for v in unique_videos
                        if scene_of_video[v] == sid]
                scene_averages[key][sid] = float(np.mean(vals))

        for key, per_video in video_averages.items():
            video_avg = np.array([per_video[v] for v in unique_videos])
            scene_avg = np.array(
                [scene_averages[key][s] for s in unique_scenes]
            )
            logs[f"{name}/{key}"] = float(video_avg.mean())
            logs[f"{name}/average_over_videos/{key}"] = float(video_avg.mean())
            logs[f"{name}/average_over_scenes/{key}"] = float(scene_avg.mean())
            for sid in unique_scenes:
                logs[f"{name}/scene/{sid}/{key}"] = scene_averages[key][sid]
            for vid in unique_videos:
                logs[f"{name}/video/{vid}/{key}"] = per_video[vid]

        if "pred_score" in video_averages and "mos" in video_averages:
            report = scene_grouped_correlations(
                video_averages["pred_score"], video_averages["mos"], scene_of_video
            )
            self._log_correlation_report(logs, report, "mos")
            logs[f"{name}/combined_score"] = combined_score(report)
            if "overall" in report:
                self.last_correlations = report["overall"]
                if "mse" in video_averages:
                    self.last_mse = float(
                        np.mean([video_averages["mse"][v] for v in unique_videos])
                    )
                if "loss" in video_averages:
                    self.last_loss = float(
                        np.mean([video_averages["loss"][v] for v in unique_videos])
                    )
            if "dmos" in video_averages:
                dreport = scene_grouped_correlations(
                    video_averages["pred_score"],
                    video_averages["dmos"],
                    scene_of_video,
                )
                self._log_correlation_report(logs, dreport, "dmos")

        self.log_fn(logs, step=step)
        self.last_logs = logs
        self._reset()
        return logs

    def _log_correlation_report(self, logs, report, target: str) -> None:
        name = self.collection_name
        for sid, corr in report.get("per_scene", {}).items():
            for m, v in corr.items():
                logs[f"{name}/correlations/scene/{sid}/{target}/{m}"] = v
        for section, prefix in (
            ("overall", f"{name}/correlations/{target}"),
            ("real", f"{name}/correlations/real/{target}"),
            ("synthetic", f"{name}/correlations/synthetic/{target}"),
            ("scene_min", f"{name}/correlations/scene_min/{target}"),
            ("scene_mean", f"{name}/correlations/scene_mean/{target}"),
            ("real_scene_mean", f"{name}/real/correlations/scene_mean/{target}"),
            ("synth_scene_mean", f"{name}/synthetic/correlations/scene_mean/{target}"),
        ):
            for m, v in report.get(section, {}).items():
                logs[f"{prefix}/{m}"] = v


class MetricAggregator:
    """Simple running-mean loss logger (train-nr.py:98-140 equivalent)."""

    def __init__(self, name: str, log_fn: Callable | None = None):
        self.name = name
        self.log_fn = log_fn or (lambda logs, step: None)
        self.values: dict[str, list[float]] = {}

    def add(self, metrics: Mapping) -> None:
        for k, v in metrics.items():
            self.values.setdefault(k, []).append(float(np.mean(np.asarray(v))))

    def log_summary(self, step: int) -> dict:
        logs = {
            f"{self.name}/{k}": float(np.mean(v)) for k, v in self.values.items()
        }
        self.log_fn(logs, step=step)
        self.values = {}
        return logs
