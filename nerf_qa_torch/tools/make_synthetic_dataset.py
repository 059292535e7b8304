"""Synthetic dataset fixture generator.

Counterpart of ``nerf_qa_tpu/tools/make_synthetic_dataset.py``, written
with ``csv`` and PIL. The reference's datasets are absolute paths on the
author's machine (run_final.py:39-42); this builds tiny structurally
identical trees so every pipeline runs end to end anywhere:

* FR / Test2 layout (``make_fr_tree``): Reference/<video>/*.png +
  Renders/<video>/*.png + scores.csv (distorted_folder,
  reference_folder, scene, frame_count, MOS, DMOS[, DISTS])
* NR layout (``make_nr_tree``): <scene>/<method>/color/*.png +
  <scene>/gt/*.png + output.csv (scene, method, frame_count, basenames,
  DISTS_std, DISTS_mean, render_dir, gt_dir)

The same seed gives the JAX tool's images and CSV values. Distortion
strength is tied to MOS (FR) or grows with the method index (NR), so
trained models have signal to find.

Usage:
  python -m nerf_qa_torch.tools.make_synthetic_dataset --root /tmp/data \
      [--kind fr|nr|both]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
from PIL import Image

def _scene_image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f1, f2 = rng.uniform(5, 30, 2)
    img = np.stack([
        0.5 + 0.5 * np.sin(xx / f1) * np.cos(yy / f2),
        (xx + yy) / (h + w),
        rng.random((h, w)),
    ], axis=-1)
    return np.clip(img, 0, 1)


def _save(path, img):
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def _write_csv(path: str, rows: list[dict]) -> str:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return path


def make_fr_tree(root: str, scenes=("lego", "truck", "ship", "fortress"),
                 methods_per_scene: int = 3, frames: int = 4,
                 hw=(96, 128), seed: int = 0, dists_col: bool = True) -> str:
    """Write the FR tree under ``root``; return the CSV's path.

    ``dists_col=False`` omits the fabricated DISTS column so the trainers
    fall back to scoring the videos with the REAL metric for head init —
    required when training runs on random backbone weights, whose score
    scale is nothing like the fabricated 0.1+1.5σ: a logistic head
    curve_fit to the fabricated scale saturates on the actual scores and
    stalls training."""
    rng = np.random.default_rng(seed)
    rows = []
    for scene in scenes:
        base_frames = [_scene_image(rng, *hw) for _ in range(frames)]
        ref_name = f"{scene}_reference"
        ref_dir = os.path.join(root, "Reference", ref_name)
        os.makedirs(ref_dir, exist_ok=True)
        for f, img in enumerate(base_frames):
            _save(os.path.join(ref_dir, f"{f:03d}.png"), img)
        for m in range(methods_per_scene):
            sigma = 0.03 + 0.1 * m
            mos = float(np.clip(5.0 - 12.0 * sigma + rng.normal(0, 0.1), 1, 5))
            dist_name = f"{scene}_m{m}"
            dist_dir = os.path.join(root, "Renders", dist_name)
            os.makedirs(dist_dir, exist_ok=True)
            for f, img in enumerate(base_frames):
                noisy = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1)
                _save(os.path.join(dist_dir, f"{f:03d}.png"), noisy)
            row = {
                "distorted_folder": dist_name,
                "reference_folder": ref_name,
                "scene": scene,
                "frame_count": frames,
                "MOS": mos,
                "DMOS": 6.0 - mos,
            }
            if dists_col:
                row["DISTS"] = 0.1 + 1.5 * sigma
            rows.append(row)
    return _write_csv(os.path.join(root, "scores.csv"), rows)


def make_nr_tree(root: str, scenes=("chair", "drums", "room"),
                 methods=("nerfacto", "instant-ngp"), frames: int = 4,
                 hw=(96, 128), seed: int = 0) -> str:
    """Write the NR tree under ``root``; return the CSV's path."""
    rng = np.random.default_rng(seed)
    rows = []
    for scene in scenes:
        base_frames = [_scene_image(rng, *hw) for _ in range(frames)]
        gt_dir = os.path.join(root, scene, "gt")
        os.makedirs(gt_dir, exist_ok=True)
        names = [f"{f:03d}.png" for f in range(frames)]
        for name, img in zip(names, base_frames):
            _save(os.path.join(gt_dir, name), img)
        for mi, method in enumerate(methods):
            sigma = 0.05 + 0.08 * mi
            color_dir = os.path.join(root, scene, method, "color")
            os.makedirs(color_dir, exist_ok=True)
            for name, img in zip(names, base_frames):
                noisy = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1)
                _save(os.path.join(color_dir, name), noisy)
            rows.append({
                "scene": scene,
                "method": method,
                "frame_count": frames,
                "basenames": str(names),
                "DISTS_std": str([round(0.01 + 0.002 * f, 4) for f in range(frames)]),
                "DISTS_mean": str([round(0.1 + 1.2 * sigma, 4)] * frames),
                "render_dir": f"{scene}/{method}/color",
                "gt_dir": f"{scene}/gt",
            })
    return _write_csv(os.path.join(root, "output.csv"), rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="write synthetic dataset trees")
    p.add_argument("--root", required=True)
    p.add_argument("--kind", choices=["fr", "nr", "both"], default="nr")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    if args.kind == "both":
        print("FR csv:", make_fr_tree(os.path.join(args.root, "fr"),
                                      frames=args.frames, seed=args.seed))
        print("NR csv:", make_nr_tree(os.path.join(args.root, "nr"),
                                      frames=args.frames, seed=args.seed))
    elif args.kind == "fr":
        print("FR csv:", make_fr_tree(args.root, frames=args.frames, seed=args.seed))
    else:
        print("NR csv:", make_nr_tree(args.root, frames=args.frames, seed=args.seed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
