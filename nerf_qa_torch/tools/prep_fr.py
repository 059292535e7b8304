"""FR dataset statistics prep, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/prep_fr.py``. Reference behavior:
prep.py / test2_prep.py / data_prep.py — per video, compute DISTS
(+ADISTS) mean/std/min/max and per-frame score lists under multiple
resize policies (aspect-preserving 256, square 256x256, full-size,
equal-pixel-count H*W≈256²; test2_prep.py:109-114,221-227,421-435),
writing enriched score CSVs (scores_square.csv etc.).

DISTS takes (render, ref) and ADISTS (ref, render), as the JAX tool and
test2_prep.py:150-155 do. On the card DISTS takes the fused moments
kernel and ADISTS the windowed T/S kernel (the port's default
``ADISTSConfig``); CPU tensors take their plain versions (``--device
cpu``). ``--iqa`` adds comparison-metric columns (``eval/iqa.py``, in
true fp32 whatever ``--compute-dtype`` says), each called as
``fn(render, ref)`` except VIF and MAD, whose models read the reference
first; LPIPS and ST-LPIPS share the resident VGG with the DISTS column.

Usage:
  python -m nerf_qa_torch.tools.prep_fr --data-dir <Test2 root> \\
      --scores-csv scores.csv --policy square [--iqa psnr,ssim,...] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import math
import os

import numpy as np
import torch

from nerf_qa_torch.compat.pretrained import (
    add_backbone_args,
    resolve_dists_weights,
    resolve_lpips_weights,
    resolve_stlpips_weights,
    resolve_vgg_params,
)
from nerf_qa_torch.config import ADISTSConfig, DISTSConfig, resolve_device
from nerf_qa_torch.core import adists, dists
from nerf_qa_torch.data.imaging import load_image_rgb, resize_image, resize_shortest_side
from nerf_qa_torch.eval import iqa

POLICIES = ("aspect", "square", "full_size", "pixel_count")
IQA_METRICS = ("psnr", "ssim", "ms-ssim", "lpips", "st-lpips", "gmsd", "vif",
               "fsim", "fsimc", "nlpd", "mad")


def apply_policy(img: np.ndarray, policy: str) -> np.ndarray:
    """The four resize policies of test2_prep.py."""
    h, w = img.shape[:2]
    if policy == "square":
        return resize_image(img, 256, 256)
    if policy == "aspect":
        return resize_shortest_side(img, 256) if min(h, w) > 256 else img
    if policy == "pixel_count":
        # equal pixel count: scale so H*W ~= 256^2 (test2_prep.py:421-435)
        scale = math.sqrt(256 * 256 / (h * w))
        return resize_image(img, max(1, round(h * scale)),
                            max(1, round(w * scale)))
    return img  # full_size


class PairScorer:
    """DISTS / ADISTS pair scorer on one device, with the comparison-metric
    columns of ``iqa_metrics`` (prep.py:344-394's correlation-table
    inputs)."""

    def __init__(self, compute_dtype="bfloat16", with_adists=True,
                 vgg_ckpt=None, dists_weights=None, iqa_metrics=(),
                 lpips_ckpt=None, stlpips_ckpt=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.dcfg = DISTSConfig(compute_dtype=compute_dtype, stats_impl="kernel")
        self.vgg = resolve_vgg_params(vgg_ckpt, seed=0).to(self.device).eval()
        self.weights = resolve_dists_weights(self.dcfg, dists_weights).to(self.device)
        self.acfg = ADISTSConfig(compute_dtype=compute_dtype)
        self.with_adists = with_adists
        self._iqa = {}
        for name in iqa_metrics:
            if name == "psnr":
                self._iqa["PSNR"] = iqa.psnr
            elif name == "ssim":
                self._iqa["SSIM"] = iqa.ssim
            elif name == "ms-ssim":
                self._iqa["MS-SSIM"] = iqa.ms_ssim
            elif name == "lpips":
                lin = resolve_lpips_weights(lpips_ckpt)
                self._iqa["LPIPS"] = lambda d, r, _lin=lin: iqa.lpips(self.vgg, d, r, _lin)
            elif name == "st-lpips":
                lin = resolve_stlpips_weights(stlpips_ckpt)
                self._iqa["ST-LPIPS"] = (
                    lambda d, r, _lin=lin: iqa.st_lpips(self.vgg, d, r, _lin))
            elif name == "gmsd":
                self._iqa["GMSD"] = iqa.gmsd
            elif name == "vif":
                # VIF's reference argument comes first
                self._iqa["VIF"] = lambda d, r: iqa.vif(r, d)
            elif name == "fsim":
                self._iqa["FSIM"] = iqa.fsim
            elif name == "fsimc":
                self._iqa["FSIMc"] = iqa.fsimc
            elif name == "nlpd":
                # the pyramid's depth clamped to the frame size (aspect and
                # full_size frames can be small; 6 levels need min side 96)
                self._iqa["NLPD"] = lambda d, r: iqa.nlpd(
                    d, r, levels=iqa.nlpd_max_levels(*d.shape[1:3]))
            elif name == "mad":
                # MAD's contrast-masking model reads its FIRST argument,
                # the reference: swapped like VIF
                self._iqa["MAD"] = lambda d, r: iqa.mad(r, d)
            else:
                raise SystemExit(f"unknown --iqa metric {name!r}")

    def score_pairs(self, ref: np.ndarray, render: np.ndarray) -> dict[str, np.ndarray]:
        r = torch.as_tensor(ref).to(self.device)
        d = torch.as_tensor(render).to(self.device)
        with torch.no_grad():
            out = {"DISTS": dists.forward(self.vgg, self.weights, d, r, self.dcfg)}
            if self.with_adists:
                out["ADISTS"] = adists.forward(self.vgg, r, d, self.acfg, as_loss=False)
            for key, fn in self._iqa.items():
                out[key] = fn(d, r)
        return {k: v.float().cpu().numpy() for k, v in out.items()}


def prep_video(scorer: PairScorer, ref_dir: str, render_dir: str,
               policy: str, batch_size: int = 8) -> dict:
    ref_files = sorted(f for f in os.listdir(ref_dir)
                       if f.endswith((".png", ".jpg")))
    render_files = sorted(f for f in os.listdir(render_dir)
                          if f.endswith((".png", ".jpg")))
    scores: dict[str, list] = {}
    for lo in range(0, len(ref_files), batch_size):
        refs = np.stack([
            apply_policy(load_image_rgb(os.path.join(ref_dir, f)), policy)
            for f in ref_files[lo:lo + batch_size]
        ])
        renders = np.stack([
            apply_policy(load_image_rgb(os.path.join(render_dir, f)), policy)
            for f in render_files[lo:lo + batch_size]
        ])
        for key, vals in scorer.score_pairs(refs, renders).items():
            scores.setdefault(key, []).extend(vals.tolist())
    out = {}
    for key, vals in scores.items():
        arr = np.asarray(vals)
        out[f"{key}"] = float(arr.mean())
        out[f"{key}_std"] = float(arr.std())
        out[f"{key}_min"] = float(arr.min())
        out[f"{key}_max"] = float(arr.max())
        out[f"{key}_frames"] = str([round(float(v), 6) for v in arr])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Precompute DISTS/ADISTS stats")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--scores-csv", required=True)
    p.add_argument("--policy", default="square", choices=POLICIES)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-adists", action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--output-csv", default=None)
    p.add_argument("--iqa", default="",
                   help="comma-separated comparison-metric columns to add "
                        f"({','.join(IQA_METRICS)}); the reference consumed "
                        "these from external CSVs (prep.py:344-394)")
    p.add_argument("--lpips-ckpt", default=None,
                   help="official lpips vgg.pth lin weights "
                        "($NERF_QA_LPIPS_CKPT); without it LPIPS uses "
                        "uniform channel weights")
    p.add_argument("--stlpips-ckpt", default=None,
                   help="official ShiftTolerant-LPIPS vgg lin weights "
                        "($NERF_QA_STLPIPS_CKPT); without it ST-LPIPS "
                        "uses uniform channel weights")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    args = p.parse_args(argv)

    with open(args.scores_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    scorer = PairScorer(args.compute_dtype, with_adists=not args.no_adists,
                        vgg_ckpt=args.vgg_ckpt,
                        dists_weights=args.dists_weights,
                        iqa_metrics=tuple(m for m in args.iqa.split(",") if m),
                        lpips_ckpt=args.lpips_ckpt, stlpips_ckpt=args.stlpips_ckpt,
                        device=args.device)
    out_rows = []
    for row in rows:
        ref_dir = os.path.join(args.data_dir, "Reference", row["reference_folder"])
        render_dir = os.path.join(args.data_dir, "Renders", row["distorted_folder"])
        stats = prep_video(scorer, ref_dir, render_dir, args.policy,
                           args.batch_size)
        out_rows.append({**row, **stats})
        print(row["distorted_folder"], {k: round(v, 4) for k, v in stats.items()
                                        if isinstance(v, float)})
    out_csv = args.output_csv or args.scores_csv.replace(
        ".csv", f"_{args.policy}.csv"
    )
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(out_rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(out_rows)
    print("wrote", out_csv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
