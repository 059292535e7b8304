"""NR dataset prep, on the GPU: per-frame DISTS scores, scene-level stats,
score maps.

Counterpart of ``nerf_qa_tpu/tools/prep_nr.py``. Reference behavior:
nerf_qa/nerf_nr_qa_prep.py (+_2/_3/_4) — walk NeRF-NR-QA render trees
computing per-frame DISTS scores -> output.csv (_2.py:26-70); add
per-scene across-method DISTS std/mean columns (_3.py:27-44); write
ADISTS score-map PNGs with the -log10 map encoded into 0-255 with its
per-frame log_min/log_max (_4.py:101-135).

The CSV is written with ``csv`` in the JAX tool's layout (pandas'
``to_csv(index=False)``), so the two tools' files are byte-identical for
equal scores. On the card the DISTS columns take the moments kernel
(``PairScorer``) and the score maps the windowed T/S kernel (the port's
default ``ADISTSConfig``); CPU tensors take their plain versions
(``--device cpu``).

Usage:
  python -m nerf_qa_torch.tools.prep_nr --data-dir <NeRF-NR-QA root> \\
      [--score-maps] [--device cpu]
"""
from __future__ import annotations

import argparse
import ast
import csv
import os

import numpy as np
import torch
from PIL import Image

from nerf_qa_torch.compat.pretrained import add_backbone_args
from nerf_qa_torch.config import ADISTSConfig
from nerf_qa_torch.core import adists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.data.imaging import load_image_rgb, load_resized, resize_image
from nerf_qa_torch.tools.prep_fr import PairScorer


def _frames(folder: str) -> list[str]:
    return sorted(f for f in os.listdir(folder) if f.endswith((".png", ".jpg")))


def walk_render_tree(root: str):
    """Yield (scene, method, color_dir, gt_dir) for <scene>/<method>/color
    layouts (_2.py:26-70)."""
    for scene in sorted(os.listdir(root)):
        scene_dir = os.path.join(root, scene)
        gt_dir = os.path.join(scene_dir, "gt")
        if not (os.path.isdir(scene_dir) and os.path.isdir(gt_dir)):
            continue
        for method in sorted(os.listdir(scene_dir)):
            color_dir = os.path.join(scene_dir, method, "color")
            if os.path.isdir(color_dir):
                yield scene, method, color_dir, gt_dir


def compute_frame_scores(scorer: PairScorer, color_dir: str, gt_dir: str,
                         batch_size: int = 8) -> tuple[list[str], np.ndarray]:
    """(frame names, per-frame DISTS of render against gt at 256²)."""
    names = _frames(color_dir)
    scores = []
    for lo in range(0, len(names), batch_size):
        chunk = names[lo:lo + batch_size]
        renders = np.stack([load_resized(os.path.join(color_dir, n), 256, 256)
                            for n in chunk])
        gts = np.stack([load_resized(os.path.join(gt_dir, n), 256, 256) for n in chunk])
        scores.extend(scorer.score_pairs(gts, renders)["DISTS"].tolist())
    return names, np.asarray(scores)


def add_scene_stats(rows: list[dict]) -> list[dict]:
    """Per-scene across-method per-frame DISTS std/mean columns
    (_3.py:27-44), as ``DISTS_std`` and ``DISTS_mean``."""
    out = []
    for row in rows:
        per_method = np.stack([np.asarray(ast.literal_eval(r["DISTS_frames"]))
                               for r in rows if r["scene"] == row["scene"]])
        out.append(dict(
            row,
            DISTS_std=str([round(float(v), 6) for v in per_method.std(axis=0)]),
            DISTS_mean=str([round(float(v), 6) for v in per_method.mean(axis=0)])))
    return out


def log_score_map(vgg: VGG16Pyramid, gt: torch.Tensor, render: torch.Tensor,
                  cfg: ADISTSConfig = ADISTSConfig()) -> np.ndarray:
    """``-log10(max(ADISTS map, 1e-6))`` of (gt, render), NHWC batches on
    one device, as (N, H, W) float32 numpy."""
    with torch.no_grad():
        dist_map = adists.forward(vgg, gt, render, cfg, as_map=True)
    return -np.log10(np.clip(dist_map.cpu().numpy(), 1e-6, None))


def encode_log_map(logm: np.ndarray) -> tuple[np.ndarray, float, float]:
    """A frame's -log10 map -> (uint8 levels over its own range, log_min,
    log_max), as _4.py:101-135 encodes it."""
    lo, hi = float(logm.min()), float(logm.max())
    enc = ((logm - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    return enc, lo, hi


def write_score_maps(vgg: VGG16Pyramid, color_dir: str, gt_dir: str, out_dir: str,
                     cfg: ADISTSConfig = ADISTSConfig(),
                     device: str | torch.device = "cuda"):
    """-log10-encoded ADISTS distortion-map PNGs (_4.py:101-135), one per
    frame at 256², and their log ranges (lists of floats, 6 decimals)."""
    os.makedirs(out_dir, exist_ok=True)
    log_mins, log_maxs = [], []
    for n in _frames(color_dir):
        render = resize_image(load_image_rgb(os.path.join(color_dir, n)), 256, 256)
        gt = resize_image(load_image_rgb(os.path.join(gt_dir, n)), 256, 256)
        logm = log_score_map(vgg, torch.from_numpy(gt[None]).to(device),
                             torch.from_numpy(render[None]).to(device), cfg)[0]
        enc, lo, hi = encode_log_map(logm)
        Image.fromarray(enc, "L").save(os.path.join(out_dir, n))
        log_mins.append(round(lo, 6))
        log_maxs.append(round(hi, 6))
    return log_mins, log_maxs


def write_rows(path: str, rows: list[dict]) -> None:
    """The CSV as pandas' ``to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="NR dataset prep")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--output-csv", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--score-maps", action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    args = p.parse_args(argv)

    scorer = PairScorer(args.compute_dtype, with_adists=False,
                        vgg_ckpt=args.vgg_ckpt, dists_weights=args.dists_weights,
                        device=args.device)
    rows = []
    for scene, method, color_dir, gt_dir in walk_render_tree(args.data_dir):
        names, scores = compute_frame_scores(scorer, color_dir, gt_dir, args.batch_size)
        row = {
            "scene": scene,
            "method": method,
            "frame_count": len(names),
            "basenames": str(names),
            "DISTS_frames": str([round(float(s), 6) for s in scores]),
            "render_dir": os.path.relpath(color_dir, args.data_dir),
            "gt_dir": os.path.relpath(gt_dir, args.data_dir),
        }
        if args.score_maps:
            out_dir = os.path.join(os.path.dirname(color_dir), "score-map")
            log_mins, log_maxs = write_score_maps(
                scorer.vgg, color_dir, gt_dir, out_dir,
                ADISTSConfig(compute_dtype=args.compute_dtype), scorer.device)
            row["score_map_log_min"] = str(log_mins)
            row["score_map_log_max"] = str(log_maxs)
        rows.append(row)
        print(scene, method, "mean DISTS", float(scores.mean()))
    out_csv = args.output_csv or os.path.join(args.data_dir, "output.csv")
    write_rows(out_csv, add_scene_stats(rows))
    print("wrote", out_csv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
