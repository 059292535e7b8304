"""Plotly-schema figures without the plotly package.

Counterpart of ``nerf_qa_tpu/logging/figures.py`` (a copy; numpy only).
Reference behavior: logger.py:36-59,207 — a plotly per-scene regression
scatter (pred score vs MOS, one color + OLS trendline per scene) logged
to wandb on every eval pass. The plotly package is absent from this
environment, but a plotly figure is just JSON ({"data": [...traces],
"layout": {...}}), so this module builds the schema directly:

* ``per_scene_regression_figure`` -> a plain dict any plotly runtime
  renders (``plotly.io.from_json``, the wandb UI, plotly.js);
* ``write_figure_json`` -> a ``.plotly.json`` artifact next to the run's
  CSVs;
* ``to_wandb`` -> a ``wandb.Plotly`` when wandb (and plotly) exist, else
  None — the glue degrades exactly like the rest of the wandb shim.

OLS trendlines are computed here in numpy (the reference delegated to
plotly express's internal OLS).
"""
from __future__ import annotations

import json
from typing import Mapping

import numpy as np

# plotly's default qualitative palette (D3) so rendered figures look
# like the reference's express output
_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
           "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")


def _ols_line(x: np.ndarray, y: np.ndarray):
    """(x_line, y_line) least-squares fit; None for degenerate inputs."""
    if len(x) < 2 or float(np.ptp(x)) == 0.0:
        return None
    slope, intercept = np.polyfit(x, y, 1)
    xs = np.array([float(x.min()), float(x.max())])
    return xs, slope * xs + intercept


def per_scene_regression_figure(
    x_by_video: Mapping, y_by_video: Mapping, scene_of_video: Mapping,
    x_title: str = "pred_score", y_title: str = "mos",
    title: str = "Per-scene regression",
) -> dict:
    """Plotly figure dict: per-scene scatter of video-level (x, y) pairs
    plus a per-scene OLS trendline (logger.py:36-59 semantics)."""
    scenes: dict = {}
    for vid, x in x_by_video.items():
        if vid not in y_by_video:
            continue
        scenes.setdefault(str(scene_of_video[vid]), []).append(
            (float(x), float(y_by_video[vid]))
        )
    data = []
    for i, (scene, pts) in enumerate(sorted(scenes.items())):
        xs = np.array([p[0] for p in pts])
        ys = np.array([p[1] for p in pts])
        color = _COLORS[i % len(_COLORS)]
        data.append({
            "type": "scatter", "mode": "markers", "name": scene,
            "legendgroup": scene,
            "x": xs.tolist(), "y": ys.tolist(),
            "marker": {"color": color},
        })
        line = _ols_line(xs, ys)
        if line is not None:
            data.append({
                "type": "scatter", "mode": "lines",
                "name": f"{scene} (fit)", "legendgroup": scene,
                "showlegend": False,
                "x": line[0].tolist(), "y": line[1].tolist(),
                "line": {"color": color, "dash": "dash"},
            })
    return {
        "data": data,
        "layout": {
            "title": {"text": title},
            "xaxis": {"title": {"text": x_title}},
            "yaxis": {"title": {"text": y_title}},
        },
    }


def write_figure_json(fig: dict, path: str) -> str:
    """Write a ``*.plotly.json`` artifact (plotly.io.from_json-loadable)."""
    with open(path, "w") as f:
        json.dump(fig, f)
    return path


def to_wandb(fig: dict):
    """wandb.Plotly for the figure dict, or None when wandb/plotly are
    absent (callers log the JSON artifact instead)."""
    try:
        import plotly.io  # noqa: F401
        import wandb

        return wandb.Plotly(plotly.io.from_json(json.dumps(fig)))
    except Exception:
        return None
