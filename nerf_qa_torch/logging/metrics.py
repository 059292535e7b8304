"""Metric logging for the trainers.

Counterpart of ``nerf_qa_tpu/logging/metrics.py``, the part the NR
trainer uses: ``MetricAggregator`` (train-nr.py:98-140's running-mean
loss logger), the JSONL sink and the wandb artifact shim (a no-op without
wandb). ``MetricCollectionLogger`` comes with FR training.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Mapping

import numpy as np


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
