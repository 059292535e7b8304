"""Precompute the NR ViT-token cache, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/cache_nr_features.py``. Reference
behavior: nerf_qa/model.py:165-196 — run the frozen encoder over the NR
dataset and save the features per frame beside each video. This tool runs
the port's frozen ViT over every video's canonical (un-augmented) 224²
renders in fixed-shape batches (the tail padded with its last frame and
trimmed) and writes one packed fp16 token file per video
(``data/feature_cache.py``'s layout, which the JAX package reads too).
``tools/train_nr.py --feature-cache`` then skips the ViT in every step.

Usage:
  python -m nerf_qa_torch.tools.cache_nr_features \\
      --data-dir <NeRF-NR-QA root> --scores-csv output.csv \\
      --cache-dir <out root> [--vit-ckpt dinov2.pth] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.utils.data import DataLoader

from nerf_qa_torch.compat.pretrained import add_backbone_args, resolve_vit_params
from nerf_qa_torch.config import resolve_device
from nerf_qa_torch.data.datasets import NerfNRQADataset, parse_list_column
from nerf_qa_torch.data.feature_cache import token_cache_path, write_token_cache
from nerf_qa_torch.data.pipeline import recursive_collate
from nerf_qa_torch.models.nr.vit import ViTS14
from nerf_qa_torch.tools.train_nr import read_rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NR ViT-token cache builder")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--scores-csv", required=True)
    p.add_argument("--cache-dir", required=True,
                   help="cache root (features/ trees are created under it, "
                        "mirroring the render directories' parents)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--sem-size", type=int, default=224)
    p.add_argument("--vit-depth", type=int, default=12)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    return p


def video_tokens(vit: ViTS14, r224: np.ndarray, batch_size: int,
                 device: torch.device) -> np.ndarray:
    """(n, gh, gw, dim) fp16 patch tokens of one video's (n, s, s, 3)
    renders, in batches of ``batch_size``."""
    chunks = []
    for lo in range(0, r224.shape[0], batch_size):
        x = r224[lo:lo + batch_size]
        n = x.shape[0]
        if n < batch_size:  # the fixed batch shape, trimmed after
            x = np.concatenate([x, np.repeat(x[-1:], batch_size - n, 0)])
        with torch.no_grad():
            out = vit(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        gh, gw = out["grid"]
        toks = out["x_norm_patchtokens"].reshape(batch_size, gh, gw, -1)
        chunks.append(toks[:n].to(torch.float16).cpu().numpy())
    return np.concatenate(chunks)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rows = read_rows(args.scores_csv)
    vit = resolve_vit_params(args.vit_ckpt, depth=args.vit_depth,
                             grid_size=args.sem_size // 14).to(device).eval()
    t0 = time.time()
    n_frames = 0
    for video_idx, row in enumerate(rows):
        out_file = token_cache_path(args.cache_dir, row["render_dir"])
        if os.path.exists(out_file) and not args.overwrite:
            continue
        ds = NerfNRQADataset([row], dir=args.data_dir, mode="gt", is_train=False,
                             sem_size=args.sem_size)
        # in order: the cache's frame order is the dataset's frame index
        loader = DataLoader(ds, batch_size=args.batch_size,
                            num_workers=args.num_workers, collate_fn=recursive_collate)
        r224 = np.concatenate([np.asarray(b[1]["224x224"]) for b in loader])
        tokens = video_tokens(vit, r224, args.batch_size, device)
        write_token_cache(out_file, tokens, parse_list_column(row["basenames"]))
        n_frames += tokens.shape[0]
        print(f"[{video_idx + 1}/{len(rows)}] {out_file}: {tokens.shape} fp16")
    dt = time.time() - t0
    print(f"cached {n_frames} frames in {dt:.1f}s "
          f"({n_frames / max(dt, 1e-9):.1f} fr/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
