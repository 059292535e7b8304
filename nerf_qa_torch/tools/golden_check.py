"""Golden DISTS parity check: reproduce the reference's 0.3347 demo score.

Counterpart of ``nerf_qa_tpu/tools/golden_check.py``. Reference behavior:
DISTS_pt.py:220-239 — score the demo image pair (images/r0.png vs r1.png)
with pretrained VGG16 + weights.pt α/β; the expected score is documented
as ``# score: 0.3347`` (:239).

The pyramid runs in fp32 (true fp32, no TF32). On the card the statistics
take the fused moments kernel, the port's default for CUDA tensors; on the
CPU (``--device cpu``) they take the eager two-pass moments.

One-command recipe (needs the torchvision VGG16 checkpoint and the demo
images):

  NERF_QA_VGG_CKPT=/path/vgg16-397923af.pth \\
  python -m nerf_qa_torch.tools.golden_check --ref r0.png --dist r1.png

Exits 0 and prints the score when |score - 0.3347| < 1e-3 (the golden
value is quoted to 4 decimals); nonzero otherwise. With --expect any pair
can be checked against any value.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nerf_qa_torch.compat.pretrained import (
    add_backbone_args,
    resolve_dists_weights,
    resolve_vgg_params,
)
from nerf_qa_torch.config import DISTSConfig, resolve_device
from nerf_qa_torch.core import dists

GOLDEN = 0.3347


def prepare_image(path: str) -> np.ndarray:
    """PIL load + resize-to-256 exactly like DISTS_pt.py:210-217
    (antialiased PIL bilinear when min side > 256)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if min(img.size) > 256:
        img = img.resize((256, 256), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr[None]  # (1, H, W, 3)


def compute_pair_score(ref_path: str, dist_path: str,
                       vgg_ckpt: str | None = None,
                       dists_weights: str | None = None,
                       device: str | torch.device | None = None) -> float:
    """DISTS(dist, ref) of two image files with the fp32 pyramid."""
    device = resolve_device(device)
    cfg = DISTSConfig(compute_dtype="float32",
                      stats_impl="kernel" if device.type == "cuda" else "eager")
    vgg = resolve_vgg_params(vgg_ckpt).to(device).eval()
    weights = resolve_dists_weights(cfg, dists_weights).to(device)
    ref = torch.from_numpy(prepare_image(ref_path)).to(device)
    dist = torch.from_numpy(prepare_image(dist_path)).to(device)
    with torch.no_grad():
        score = dists.forward(vgg, weights, dist, ref, cfg)
    return float(score[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Golden DISTS 0.3347 check")
    p.add_argument("--ref", required=True, help="reference image (r0.png)")
    p.add_argument("--dist", required=True, help="distorted image (r1.png)")
    p.add_argument("--expect", type=float, default=GOLDEN)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    args = p.parse_args(argv)
    score = compute_pair_score(args.ref, args.dist, args.vgg_ckpt,
                               args.dists_weights, args.device)
    ok = abs(score - args.expect) < args.tol
    print(f"DISTS({args.dist}, {args.ref}) = {score:.6f} "
          f"(expect {args.expect} ± {args.tol}) -> "
          f"{'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
