"""Synthetic NR dataset fixture generator.

Counterpart of ``nerf_qa_tpu/tools/make_synthetic_dataset.py``, the NR
tree (``make_nr_tree``), written with ``csv`` and PIL. The reference's
datasets are absolute paths on the author's machine (run_final.py:39-42);
this builds a tiny structurally identical tree so NR training runs end to
end anywhere:

  <scene>/<method>/color/*.png + <scene>/gt/*.png + output.csv
  (scene, method, frame_count, basenames, DISTS_std, DISTS_mean,
  render_dir, gt_dir)

The same seed gives the JAX tool's images and CSV values. Distortion
strength grows with the method index, so trained models have signal to
find.

Usage:
  python -m nerf_qa_torch.tools.make_synthetic_dataset --root /tmp/nr
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
from PIL import Image

NR_COLUMNS = ("scene", "method", "frame_count", "basenames", "DISTS_std",
              "DISTS_mean", "render_dir", "gt_dir")


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
    csv_path = os.path.join(root, "output.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=NR_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    return csv_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="write a synthetic NR dataset tree")
    p.add_argument("--root", required=True)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    print("NR csv:", make_nr_tree(args.root, frames=args.frames, seed=args.seed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
