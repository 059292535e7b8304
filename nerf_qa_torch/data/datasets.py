"""Host-side NR frame dataset.

Counterpart of ``nerf_qa_tpu/data/datasets.py``, the part NR training
uses: the cumulative frame-count indexing (data.py:92-93, 126-133),
``parse_list_column`` and ``NerfNRQADataset`` in ``render`` and ``gt``
mode, which read the same (data.py:431-554): the render and its ground
truth, paired rotation and 0.7 center crop (+ random crop when
training), resized to the network's two input sizes, with the per-frame
DISTS std / mean targets. The score-map mode (ROADMAP Queue 1 item 11)
raises.

Rows are plain dicts (the scores CSV read with the ``csv`` module, as
``tools/train_nr.py`` does), where the JAX package takes a pandas frame.
Arrays are NHWC float32 numpy; every random number comes from the
dataset's numpy Generator, so the same seed gives the JAX package's
arrays.
"""
from __future__ import annotations

import ast
from os import path
from typing import Mapping, Sequence

import numpy as np

from nerf_qa_torch.data.imaging import (
    load_image_rgb,
    paired_random_crop,
    paired_rotate,
    resize_image,
)


def parse_list_column(value):
    """Parse a stringified list CSV cell (the reference uses eval;
    data.py:467-472)."""
    if isinstance(value, str):
        return ast.literal_eval(value)
    return value


class FrameIndexed:
    """Cumulative frame-count video->frame indexing base
    (data.py:92-93,126-133)."""

    def __init__(self, frame_counts: Sequence[int]):
        self.frame_counts = np.asarray(frame_counts, np.int64)
        self.cumulative = np.cumsum(self.frame_counts)
        self.total = int(self.cumulative[-1]) if len(self.cumulative) else 0

    def __len__(self) -> int:
        return self.total

    def locate(self, idx: int) -> tuple[int, int]:
        """Global frame index -> (video_idx, frame_within_video)."""
        video_idx = int(np.searchsorted(self.cumulative, idx, side="right"))
        frame = idx - (self.cumulative[video_idx - 1] if video_idx > 0 else 0)
        return video_idx, int(frame)

    def scene_indices(self, scenes: Sequence[str]) -> dict[str, list[int]]:
        """Scene -> global frame indices (data.py:161-171)."""
        out: dict[str, list[int]] = {}
        start = 0
        for scene, count in zip(scenes, self.frame_counts):
            out.setdefault(scene, []).extend(range(start, start + int(count)))
            start += int(count)
        return out


class NerfNRQADataset(FrameIndexed):
    """NR dataset, ``render`` (the default) or ``gt`` mode, which read the
    same: (gt at render_size², {"256x256": render at render_size²,
    "224x224": render at sem_size²}, DISTS std, DISTS mean, video index,
    frame) per frame (data.py:431-554)."""

    def __init__(
        self,
        rows: Sequence[Mapping],
        dir: str,
        mode: str = "render",
        is_train: bool = False,
        aug_crop_scale: float = 0.8,
        aug_rot_deg: float = 30.0,
        rng: np.random.Generator | None = None,
        render_size: int = 256,
        sem_size: int = 224,
    ):
        if mode not in ("render", "gt"):
            raise NotImplementedError(
                f"NR dataset mode {mode!r}: only 'render' and 'gt' are "
                "ported; the score-map mode waits for ROADMAP Queue 1 item 11")
        self.dir = dir
        self.rows = list(rows)
        self.mode = mode
        self.is_train = is_train
        self.aug_crop_scale = aug_crop_scale
        self.aug_rot_deg = aug_rot_deg
        self.rng = rng or np.random.default_rng(0)
        # network input resolutions (data.py:490-494 fixes 256/224; kept
        # configurable for ablations and low-res smoke runs)
        self.render_size = render_size
        self.sem_size = sem_size
        super().__init__([int(r["frame_count"]) for r in self.rows])

    def get_scene_indices(self):
        return self.scene_indices([r["scene"] for r in self.rows])

    def _transform_pair(self, render: np.ndarray, gt: np.ndarray):
        """Paired rotation + 0.7 center crop (+ random crop when training)
        (data.py:508-531)."""
        if self.is_train and self.aug_rot_deg > 0:
            angle = float(self.rng.uniform(-self.aug_rot_deg, self.aug_rot_deg))
            render = paired_rotate(render, angle)
            gt = paired_rotate(gt, angle)
        h, w = render.shape[:2]
        ch, cw = int(h * 0.7), int(w * 0.7)
        i, j = (h - ch) // 2, (w - cw) // 2
        render = render[i:i + ch, j:j + cw]
        gt = gt[i:i + ch, j:j + cw]
        if self.is_train:
            crop = int(self.aug_crop_scale * ch), int(self.aug_crop_scale * cw)
            render, gt = paired_random_crop(render, gt, crop[0], crop[1],
                                            self.rng)
        return render, gt

    def __getitem__(self, idx: int):
        video_idx, frame = self.locate(idx)
        row = self.rows[video_idx]
        basename = parse_list_column(row["basenames"])[frame]
        render = load_image_rgb(path.join(self.dir, row["render_dir"], basename))
        gt = load_image_rgb(path.join(self.dir, row["gt_dir"], basename))
        render, gt = self._transform_pair(render, gt)
        rs, ss = self.render_size, self.sem_size
        render_pack = {"256x256": resize_image(render, rs, rs),
                       "224x224": resize_image(render, ss, ss)}
        dists_std = parse_list_column(row["DISTS_std"])[frame]
        dists_mean = parse_list_column(row["DISTS_mean"])[frame]
        return (resize_image(gt, rs, rs), render_pack, np.float32(dists_std),
                np.float32(dists_mean), video_idx, frame)
