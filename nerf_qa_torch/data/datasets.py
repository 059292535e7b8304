"""Host-side frame datasets.

Counterpart of ``nerf_qa_tpu/data/datasets.py``:

* cumulative frame-count indexing: videos flatten into one global frame
  index (data.py:92-93,126-133)
* Test2Dataset: paired Reference/Renders frame trees + per-video MOS
  (data.py:86-171), optional uint8 in-memory cache with reference-frame
  dedup (data.py:104-120)
* LargeQADataset: NeRF-QA-Large trees with %03d frame names
  (data.py:190-227)
* NeRFQAResizedDataset: paired random resize + random crop augmentation
  (data.py:285-364)
* NerfNRQADataset (data.py:431-554): the render and its ground truth,
  paired rotation and 0.7 center crop (+ random crop when training),
  resized to the network's two input sizes, with the per-frame DISTS std
  / mean targets (``render`` and ``gt`` mode, which read the same), or
  with the prep's score map decoded to ``-log10`` values (``score-map``
  mode).
* Test2VideoDataset: per-video paired dict frames at 256²+224²
  (data.py:42-84)

Two faults of the JAX classes are mirrored, not fixed, so both packages
give the same arrays: ``Test2Dataset`` returns the ``MOS`` column as the
target whatever the score type a caller fits to, and
``Test2VideoDataset`` reads ``Reference/<distorted_folder>`` and
``Renders/<reference_folder>`` (the two folder names swapped).

Rows are plain dicts (the scores CSV read with the ``csv`` module, as
``tools/train_nr.py`` does), where the JAX package takes a pandas frame.
Arrays are NHWC float32 numpy; every random number comes from the
dataset's numpy Generator, so the same seed gives the JAX package's
arrays.
"""
from __future__ import annotations

import ast
import os
from os import path
from typing import Mapping, Sequence

import numpy as np

from nerf_qa_torch.data.imaging import (
    load_image_rgb,
    load_prepared,
    load_resized,
    paired_random_crop,
    paired_random_resize,
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


def _listdir_frames(folder: str) -> list[str]:
    files = [f for f in os.listdir(folder) if f.endswith((".jpg", ".png"))]
    files.sort()
    return files


class Test2Dataset(FrameIndexed):
    """Paired Reference/Renders frame trees (data.py:86-171): (dist, ref,
    MOS, video index) per frame."""

    def __init__(self, dir: str, rows: Sequence[Mapping], in_memory: bool = False,
                 resize: bool = True):
        self.ref_dir = path.join(dir, "Reference")
        self.dist_dir = path.join(dir, "Renders")
        self.rows = list(rows)
        self.resize = resize
        self.render_files = [
            _listdir_frames(path.join(self.dist_dir, row["distorted_folder"]))
            for row in self.rows
        ]
        self.gt_files = [
            _listdir_frames(path.join(self.ref_dir, row["reference_folder"]))
            for row in self.rows
        ]
        super().__init__([len(f) for f in self.gt_files])
        self._cache: dict[int, tuple] = {}
        self._ref_cache: dict[tuple, np.ndarray] = {}
        self.in_memory = in_memory
        if in_memory:
            for i in range(len(self)):
                self[i]

    def __getitem__(self, idx: int):
        video_idx, frame = self.locate(idx)
        row = self.rows[video_idx]
        if self.in_memory and idx in self._cache:
            dist_u8, score = self._cache[idx]
            ref_u8 = self._ref_cache[(row["reference_folder"], frame)]
            return (
                dist_u8.astype(np.float32) / 255.0,
                ref_u8.astype(np.float32) / 255.0,
                score,
                video_idx,
            )
        dist_path = path.join(self.dist_dir, row["distorted_folder"],
                              self.render_files[video_idx][frame])
        ref_path = path.join(self.ref_dir, row["reference_folder"],
                             self.gt_files[video_idx][frame])
        # prepare_image semantics: resize only when min side > 256
        # (data.py:154-155 -> DISTS_pt.py:210-217)
        dist = load_prepared(dist_path, resize=self.resize)
        ref = load_prepared(ref_path, resize=self.resize)
        score = float(row["MOS"])  # whatever the score type: mirrors JAX
        if self.in_memory:
            # quantized uint8 cache, reference frames deduped
            self._cache[idx] = ((dist * 255).astype(np.uint8), score)
            key = (row["reference_folder"], frame)
            if key not in self._ref_cache:
                self._ref_cache[key] = (ref * 255).astype(np.uint8)
        return dist, ref, score, video_idx

    def get_scene_indices(self):
        return self.scene_indices([r["distorted_folder"] for r in self.rows])


class LargeQADataset(FrameIndexed):
    """NeRF-QA-Large frame trees (data.py:190-227)."""

    def __init__(self, dir: str, rows: Sequence[Mapping], resize: bool = True):
        self.ref_dir = path.join(dir, "references")
        self.dist_dir = path.join(dir, "nerf-renders")
        self.rows = list(rows)
        self.resize = resize
        super().__init__([int(r["frame_count"]) for r in self.rows])

    def __getitem__(self, idx: int):
        video_idx, frame = self.locate(idx)
        row = self.rows[video_idx]
        dist = load_prepared(
            path.join(self.dist_dir, row["distorted_filename"],
                      f"{frame:03d}.png"), resize=self.resize,
        )
        ref = load_prepared(
            path.join(self.ref_dir, row["referenced_filename"],
                      f"{frame:03d}.png"), resize=self.resize,
        )
        return dist, ref, float(row["MOS"]), video_idx

    def get_scene_indices(self):
        return self.scene_indices([r["distorted_filename"] for r in self.rows])


class NeRFQAResizedDataset(FrameIndexed):
    """Original-size frames + paired random resize/crop augmentation
    (data.py:285-364)."""

    def __init__(self, dir: str, rows: Sequence[Mapping],
                 rng: np.random.Generator | None = None):
        self.ref_dir = path.join(dir, "Reference")
        self.dist_dir = path.join(dir, "NeRF-QA_videos")
        self.rng = rng or np.random.default_rng(0)
        self.rows = [dict(r, distorted_folder=path.splitext(r["distorted_filename"])[0],
                          reference_folder=path.splitext(r["reference_filename"])[0])
                     for r in rows]
        counts = [len(_listdir_frames(path.join(self.ref_dir, r["reference_folder"],
                                                "256x256")))
                  for r in self.rows]
        super().__init__(counts)

    def __getitem__(self, idx: int):
        video_idx, frame = self.locate(idx)
        row = self.rows[video_idx]
        dist = load_image_rgb(
            path.join(self.dist_dir, row["distorted_folder"], "original_size",
                      f"{frame:03d}.png")
        )
        ref = load_image_rgb(
            path.join(self.ref_dir, row["reference_folder"], "original_size",
                      f"{frame:03d}.png")
        )
        dist, ref = paired_random_resize(dist, ref, 256, self.rng)
        dist, ref = paired_random_crop(dist, ref, 256, 256, self.rng)
        return dist, ref, float(row["MOS"]), video_idx

    def get_scene_indices(self):
        return self.scene_indices([r["distorted_folder"] for r in self.rows])


class NerfNRQADataset(FrameIndexed):
    """NR dataset (data.py:431-554). ``render`` (the default) and ``gt``
    mode read the same: (gt at render_size², {"256x256": render at
    render_size², "224x224": render at sem_size²}, DISTS std, DISTS mean,
    video index, frame) per frame. ``score-map`` mode gives (gt, the same
    render dict, the score map, video index, frame): the map is the PNG
    that ``tools/prep_nr.py --score-maps`` wrote beside the render
    directory (``score-map/``, or ``gt-score-map/`` when the render
    directory is not named ``color``), as float RGB in [0, 1] at its own
    size, its channel 1 decoded to ``-log10`` ADISTS values with the
    frame's ``score_map_log_min`` / ``score_map_log_max`` (the whole map
    when it has one channel)."""

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
        if mode not in ("render", "gt", "score-map"):
            raise ValueError(f"NR dataset mode {mode!r}: 'render', 'gt' or "
                             "'score-map'")
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
        if self.mode == "score-map":
            return (resize_image(gt, rs, rs), render_pack,
                    self._score_map(row, basename, frame), video_idx, frame)
        dists_std = parse_list_column(row["DISTS_std"])[frame]
        dists_mean = parse_list_column(row["DISTS_mean"])[frame]
        return (resize_image(gt, rs, rs), render_pack, np.float32(dists_std),
                np.float32(dists_mean), video_idx, frame)


    def _score_map(self, row: Mapping, basename: str, frame: int) -> np.ndarray:
        render_dir = row["render_dir"]
        sub = "score-map" if path.basename(render_dir) == "color" else "gt-score-map"
        score_map = load_image_rgb(path.join(self.dir, path.dirname(render_dir), sub,
                                             basename)).copy()
        log_min = parse_list_column(row["score_map_log_min"])[frame]
        log_max = parse_list_column(row["score_map_log_max"])[frame]
        if score_map.shape[-1] == 1:
            return (log_max - log_min) * score_map + log_min
        score_map[..., 1] = (log_max - log_min) * score_map[..., 1] + log_min
        return score_map


class Test2VideoDataset:
    """Per-video paired dict frames at 256²+224² (data.py:42-84). The
    folder names are swapped as in the JAX class: the "gt" frames come
    from ``Reference/<distorted_folder>`` and the renders from
    ``Renders/<reference_folder>``."""

    def __init__(self, row: Mapping, dir: str):
        gt_dir = path.join(dir, "Reference", row["distorted_folder"])
        render_dir = path.join(dir, "Renders", row["reference_folder"])
        self.files = list(zip(
            [path.join(gt_dir, f) for f in _listdir_frames(gt_dir)],
            [path.join(render_dir, f) for f in _listdir_frames(render_dir)],
        ))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        gt_path, render_path = self.files[idx]

        def pack(p):
            return {
                "256x256": load_resized(p, 256, 256),
                "224x224": load_resized(p, 224, 224),
            }

        return pack(gt_path), pack(render_path)
