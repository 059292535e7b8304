"""Video frame loading: directories of frames.

The frame-directory branch of ``nerf_qa_tpu/data/video.load_video_frames``
(data.py:378-392 semantics), copied. mp4 decode comes with the data-feed
slice.
"""
from __future__ import annotations

import os

import numpy as np

from nerf_qa_torch.data.imaging import load_prepared

MP4_TODO = "mp4 decode is not yet ported (ROADMAP Queue 1 item 10, data feed)"


def load_video_frames(
    video_path: str,
    resize: bool = True,
    keep_aspect_ratio: bool = False,
    max_frames: int | None = None,
) -> np.ndarray:
    """Decode a directory of .png/.jpg frames to (T, H, W, 3) float32 in
    [0, 1], sorted by file name."""
    if not os.path.isdir(video_path):
        raise NotImplementedError(f"{video_path}: {MP4_TODO}")
    files = sorted(
        f for f in os.listdir(video_path) if f.endswith((".png", ".jpg"))
    )
    if max_frames:
        files = files[:max_frames]
    frames = [
        load_prepared(os.path.join(video_path, f), resize=resize,
                      keep_aspect_ratio=keep_aspect_ratio)
        for f in files
    ]
    return np.stack(frames)
