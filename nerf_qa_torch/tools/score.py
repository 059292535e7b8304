"""Score image pairs or frame directories with DISTS on the GPU.

Counterpart of the DISTS mode of ``nerf_qa_tpu/tools/score.py``: the
metric's __main__ CLI (DISTS_pt.py:220-238, one image pair) and the
per-video evaluation loops (run_test2.py:278-297 — per-frame scores
mean-pooled to a video score). Frames batch through FrameScorer: bf16
convs and the fused CUDA moments kernel by default, ``--fp32`` for the
parity path (fp32, eager statistics).

Examples:
  python -m nerf_qa_torch.tools.score --ref r0.png --dist r1.png
  python -m nerf_qa_torch.tools.score --ref gt_dir --dist render_dir \\
      --full-size --out-csv scores.csv --json
  python -m nerf_qa_torch.tools.score --ref a.png --dist b.png --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nerf_qa_torch.compat import pretrained
from nerf_qa_torch.config import DISTSConfig
from nerf_qa_torch.data.imaging import load_prepared
from nerf_qa_torch.data.video import MP4_TODO, load_video_frames
from nerf_qa_torch.eval.video_scorer import FrameScorer


def _load_frames(path: str, resize: bool, keep_aspect: bool) -> np.ndarray:
    if path.endswith((".mp4", ".mov")):
        raise SystemExit(f"{path}: {MP4_TODO}")
    if os.path.isdir(path):
        return load_video_frames(path, resize=resize,
                                 keep_aspect_ratio=keep_aspect)
    img = load_prepared(path, resize=resize, keep_aspect_ratio=keep_aspect)
    return img[None]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="DISTS scoring for image pairs or frame directories"
    )
    p.add_argument("--ref", default=None,
                   help="reference image or frame directory")
    p.add_argument("--dist", required=True,
                   help="distorted image or frame directory")
    p.add_argument("--nr", action="store_true",
                   help="no-reference mode (not yet ported)")
    p.add_argument("--metric", choices=("dists", "adists", "both"),
                   default="dists")
    p.add_argument("--full-size", action="store_true",
                   help="score at source resolution (no resize-to-256)")
    p.add_argument("--keep-aspect", action="store_true",
                   help="aspect-preserving resize (shortest side 256)")
    p.add_argument("--fp32", action="store_true",
                   help="fp32 parity mode (default: bf16 serving path)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--out-csv", default=None,
                   help="write per-frame scores as CSV")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line instead of text")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    pretrained.add_backbone_args(p)
    args = p.parse_args(argv)

    if args.nr:
        raise SystemExit("--nr is not yet ported (ROADMAP Queue 1 item 11, NR)")
    if args.metric != "dists":
        raise SystemExit(f"--metric {args.metric}: ADISTS is not yet ported "
                         "(ROADMAP Queue 1 item 7)")
    if args.ref is None:
        p.error("--ref is required")

    ref = _load_frames(args.ref, not args.full_size, args.keep_aspect)
    dist = _load_frames(args.dist, not args.full_size, args.keep_aspect)
    if ref.shape != dist.shape:
        raise SystemExit(
            f"ref/dist shapes differ: {ref.shape} vs {dist.shape}"
        )
    n = ref.shape[0]
    bs = min(args.batch_size, n)

    cfg = DISTSConfig(compute_dtype="float32" if args.fp32 else "bfloat16",
                      stats_impl="eager" if args.fp32 else "kernel")
    model = pretrained.resolve_vgg_params(args.vgg_ckpt)
    weights = pretrained.resolve_dists_weights(cfg, args.dists_weights)
    scorer = FrameScorer(model, weights, cfg, resize_to=None,
                         device=args.device)
    results = {"dists": scorer.score_frames(dist, ref, batch_size=bs)}

    if args.out_csv:
        header = "frame," + ",".join(results)
        rows = [
            f"{i}," + ",".join(f"{results[m][i]:.6f}" for m in results)
            for i in range(n)
        ]
        with open(args.out_csv, "w") as f:
            f.write(header + "\n" + "\n".join(rows) + "\n")

    summary = {
        m: {"video_score": round(float(v.mean()), 6), "frames": n}
        for m, v in results.items()
    }
    if args.json:
        print(json.dumps(summary))
    else:
        for m, s in summary.items():
            print(f"{m}: {s['video_score']:.4f}  "
                  f"(mean of {s['frames']} frame scores)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
