"""NR video-level benchmark pass: PLCC/SRCC/KTCC against MOS and DMOS for
the syn/tnt/all subsets of the NeRF-QA benchmark.

Counterpart of ``nerf_qa_tpu/eval/nr_benchmark.py``. Reference behavior:
train-nr.py:299-375 — every few epochs, score each NeRF-QA benchmark video
(per-frame NR forward, mean over frames), split by reference_filename into
tnt (truck/playground/train/m60) and syn (lego/drums/ficus/ship), and log
the correlations against MOS and DMOS, plus the L1 against the
precomputed DISTS column, as ``Test Metrics Dict/{subset}/{target}/{metric}``.

Rows are the benchmark CSV read with ``csv`` (dicts of strings). Videos
are the reference layout's mp4s (``NeRF-QA_videos/<mp4>``) or frame
directories named after each video.
"""
from __future__ import annotations

import os
from typing import Callable, Mapping, Sequence

import numpy as np

from nerf_qa_torch.data.imaging import resize_image
from nerf_qa_torch.data.video import load_video_frames
from nerf_qa_torch.eval.correlations import compute_correlations

# subset membership by reference file (train-nr.py:320-324)
TNT_FILES = (
    "truck_reference.mp4", "playground_reference.mp4",
    "train_reference.mp4", "m60_reference.mp4",
)
SYN_FILES = (
    "lego_reference.mp4", "drums_reference.mp4",
    "ficus_reference.mp4", "ship_reference.mp4",
)


def _strip(name: str) -> str:
    return os.path.splitext(str(name))[0]


TNT_NAMES = tuple(_strip(f) for f in TNT_FILES)
SYN_NAMES = tuple(_strip(f) for f in SYN_FILES)


def load_render_frames(data_dir: str, row: Mapping, max_frames: int | None = None,
                       render_size: int = 256,
                       sem_size: int = 224) -> tuple[np.ndarray, np.ndarray]:
    """The render frames of one benchmark row as (render_size², sem_size²)
    float32 stacks, from the first of ``NeRF-QA_videos/<name>``,
    ``<name>``, and the same two without the extension that exists."""
    name = str(row["distorted_filename"])
    candidates = [
        os.path.join(data_dir, "NeRF-QA_videos", name),
        os.path.join(data_dir, name),
        os.path.join(data_dir, "NeRF-QA_videos", _strip(name)),
        os.path.join(data_dir, _strip(name)),
    ]
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        raise FileNotFoundError(f"no video/frames for {name} in {data_dir}")
    frames = load_video_frames(found, resize=False, max_frames=max_frames)
    r256 = np.stack([resize_image(f, render_size, render_size) for f in frames])
    r224 = np.stack([resize_image(f, sem_size, sem_size) for f in frames])
    return r256.astype(np.float32), r224.astype(np.float32)


def score_benchmark_videos(score_video_fn: Callable, rows: Sequence[Mapping],
                           data_dir: str, max_frames: int | None = None,
                           render_size: int = 256, sem_size: int = 224) -> np.ndarray:
    """Per-video mean NR scores (train-nr.py:305-315).
    ``score_video_fn(r256, r224) -> float``, e.g. ``trainer.score_video``."""
    return np.asarray([
        float(score_video_fn(*load_render_frames(data_dir, row, max_frames,
                                                 render_size, sem_size)))
        for row in rows])


def benchmark_report(rows: Sequence[Mapping], video_scores) -> dict[str, float]:
    """Correlations against MOS and DMOS for syn/tnt/all, flat-keyed as the
    reference's logs are (train-nr.py:326-375):
    ``{subset/}{mos|dmos}/{plcc|srcc|ktcc}``, and ``{subset/}mos/l1``
    against the DISTS column when there is one. Subsets of fewer than two
    videos are left out."""
    rows = list(rows)
    scores = np.asarray(video_scores, np.float64)
    refs = [_strip(r["reference_filename"]) for r in rows]
    subsets = {
        "tnt": [i for i, r in enumerate(refs) if r in TNT_NAMES],
        "syn": [i for i, r in enumerate(refs) if r in SYN_NAMES],
        "": list(range(len(rows))),
    }
    columns = set(rows[0]) if rows else set()
    out: dict[str, float] = {}
    for prefix, idx in subsets.items():
        if len(idx) < 2:
            continue
        key = f"{prefix}/" if prefix else ""
        sub = scores[idx]
        for target, tkey in (("MOS", "mos"), ("DMOS", "dmos")):
            if target not in columns:
                continue
            values = np.asarray([float(rows[i][target]) for i in idx])
            for m, v in compute_correlations(sub, values).items():
                out[f"{key}{tkey}/{m}"] = v
        if "DISTS" in columns:
            dists = np.asarray([float(rows[i]["DISTS"]) for i in idx])
            out[f"{key}mos/l1"] = float(np.mean(np.abs(sub - dists)))
    return out
