"""Offline ViT-token cache for the NR pipeline.

Counterpart of ``nerf_qa_tpu/data/feature_cache.py``, with its file layout,
so either package reads a cache the other wrote. Reference behavior:
nerf_qa/model.py:165-196 — a one-off ``__main__`` block runs the frozen
encoder over the NR dataset and saves the features per frame beside each
video's ``color/`` directory, so training can skip the frozen forward.

The cache holds the *ViT patch tokens* ((gh, gw, 384) fp16, about 0.2 MB a
frame), the sequential part of the frozen encoder; the VGG pyramid and the
JBU upsampling recompute in each step. One packed fp16 ``.npy`` per video
(read through a memmap, so a random frame costs one page fault) plus a
JSON sidecar with its shape, dtype and frame names.

Cache contract: the tokens come from the dataset's canonical
(un-augmented) 224² render, the frames ``NerfNRQADataset(is_train=False)``
gives. Consumers turn the random augmentations off (rotation 0, crop
scale 1.0); ``tools/train_nr.py --feature-cache`` does.
"""
from __future__ import annotations

import json
import os
from os import path
from typing import Mapping, Sequence

import numpy as np

META_SUFFIX = ".json"


def token_cache_path(cache_dir: str, render_dir: str) -> str:
    """The cache file of one video: ``features/vit_tokens.npy`` beside the
    render directory (the reference's layout, model.py:186-189), rooted at
    ``cache_dir`` so read-only datasets stay untouched."""
    parent = path.dirname(render_dir.rstrip("/"))
    return path.join(cache_dir, parent, "features", "vit_tokens.npy")


def write_token_cache(cache_file: str, tokens: np.ndarray,
                      basenames: Sequence[str]) -> None:
    """``tokens``: (n_frames, gh, gw, dim), stored fp16, with its sidecar."""
    os.makedirs(path.dirname(cache_file), exist_ok=True)
    tokens = np.asarray(tokens, np.float16)
    np.save(cache_file, tokens)
    meta = {"shape": list(tokens.shape), "dtype": "float16",
            "basenames": list(basenames)}
    with open(cache_file + META_SUFFIX, "w") as f:
        json.dump(meta, f)


class TokenCacheReader:
    """Maps (video index, frame) to cached tokens for the rows of one scores
    CSV (dicts with ``render_dir``). Memmaps open lazily and stay open;
    reads return fp32 arrays."""

    def __init__(self, cache_dir: str, rows: Sequence[Mapping]):
        self.cache_dir = cache_dir
        self.render_dirs = [r["render_dir"] for r in rows]
        self._maps: dict[int, np.ndarray] = {}

    def _video(self, video_idx: int) -> np.ndarray:
        m = self._maps.get(video_idx)
        if m is None:
            f = token_cache_path(self.cache_dir, self.render_dirs[video_idx])
            m = np.load(f, mmap_mode="r")
            self._maps[video_idx] = m
        return m

    def gather(self, video_idx, frame) -> np.ndarray:
        """Batch lookup -> (B, gh, gw, dim) fp32."""
        return np.stack([np.asarray(self._video(int(v))[int(f)], np.float32)
                         for v, f in zip(np.asarray(video_idx), np.asarray(frame))])

    def coverage(self) -> tuple[int, int]:
        """(videos cached, videos in all), for a check at start-up."""
        n = sum(1 for rd in self.render_dirs
                if path.exists(token_cache_path(self.cache_dir, rd)))
        return n, len(self.render_dirs)
