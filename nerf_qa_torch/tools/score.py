"""Score image pairs or frame directories with DISTS and ADISTS, or renders
alone with the NR model, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/score.py``: the metric's __main__ CLI
(DISTS_pt.py:220-238, one image pair) and the per-video evaluation loops
(run_test2.py:278-297 — per-frame scores mean-pooled to a video score).
DISTS frames batch through FrameScorer: bf16 convs and the fused CUDA
moments kernel by default, ``--fp32`` for the parity path (fp32, eager
statistics). ADISTS (``--metric adists|both``) runs fixed-shape batches
through ``adists_batch`` with the distorted frame as ``x``, as the JAX
CLI does; ``--fp32`` sets fp32 and keeps the windowed T/S kernel.

Examples:
  python -m nerf_qa_torch.tools.score --ref r0.png --dist r1.png
  python -m nerf_qa_torch.tools.score --ref gt_dir --dist render_dir \\
      --metric both --json
  python -m nerf_qa_torch.tools.score --ref gt_dir --dist render_dir \\
      --full-size --out-csv scores.csv --json
  python -m nerf_qa_torch.tools.score --ref a.png --dist b.png --device cpu

No-reference mode (--nr) scores renders WITHOUT ground truth through an
NR v8 model (the capability the reference only exposes inside
train-nr.py's test loop, :299-375): ``--nr-ckpt`` takes a reference-layout
torch ``.pth`` (train-nr.py's saved state, or the JAX package's
nerf_qa_tpu/compat/export_torch.py --kind nr output), with its fine-tuned
α/β when present; the ViT and JBU backbones come from --vit-ckpt /
--jbu-ckpt, random otherwise.

  python -m nerf_qa_torch.tools.score --nr --dist render_dir \\
      --nr-ckpt model.pth --out-csv nr_scores.csv
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from nerf_qa_torch.compat import pretrained
from nerf_qa_torch.config import (
    ADISTSConfig,
    DISTSConfig,
    NRModelConfig,
    resolve_device,
)
from nerf_qa_torch.core import adists
from nerf_qa_torch.core.dists import weights_from_arrays
from nerf_qa_torch.data.imaging import load_prepared, resize_image
from nerf_qa_torch.data.video import MP4_TODO, load_video_frames
from nerf_qa_torch.eval.video_scorer import FrameScorer, batched_map
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.model import NRModel

# the NR model's fixed inputs: the DISTS render and the ViT render
# (render / 16 == sem / 14, model_nr_v8.py:161-164)
NR_SIZES = (256, 224)


def _load_frames(path: str, resize: bool, keep_aspect: bool) -> np.ndarray:
    if path.endswith((".mp4", ".mov")):
        raise SystemExit(f"{path}: {MP4_TODO}")
    if os.path.isdir(path):
        return load_video_frames(path, resize=resize,
                                 keep_aspect_ratio=keep_aspect)
    img = load_prepared(path, resize=resize, keep_aspect_ratio=keep_aspect)
    return img[None]


def adists_batch(model, dist, ref, cfg: ADISTSConfig) -> torch.Tensor:
    """Per-frame ADISTS (a tensor on the model's device) of one fixed-shape
    batch of float frames in [0, 1], numpy or tensors on any device. The
    distorted frame is ``x``, as in the JAX CLI (entropy weights and the
    ps cascade come from ``x``)."""
    device = next(model.parameters()).device
    x = torch.as_tensor(dist).to(device, non_blocking=True)
    y = torch.as_tensor(ref).to(device, non_blocking=True)
    with torch.no_grad():
        return adists.forward(model, x, y, cfg, as_loss=False)


class NRScorer:
    """No-reference scorer: render frames -> host resize to the model's
    fixed (256², 224²) inputs -> fixed-shape batches through
    ``NRModel.forward`` (train-nr.py:305-315 per-video semantics). The
    tail batch is padded and masked by ``batched_map``."""

    def __init__(self, model: NRModel, batch_size: int = 16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size

    def prep_frames(self, frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host resize of float frames (N, H, W, 3) in [0, 1] to the
        model's two input sizes."""
        r256 = np.stack([resize_image(f, self.model.render_size,
                                      self.model.render_size) for f in frames])
        r224 = np.stack([resize_image(f, self.model.sem_size,
                                      self.model.sem_size) for f in frames])
        return r256, r224

    def step_batch(self, r256, r224) -> torch.Tensor:
        """Per-frame scores (a device tensor) of one prepped batch; numpy
        arrays and tensors on any device are accepted."""
        a = torch.as_tensor(r256).to(self.device, non_blocking=True)
        b = torch.as_tensor(r224).to(self.device, non_blocking=True)
        with torch.no_grad():
            return self.model(a, b)

    def score_frames(self, frames: np.ndarray) -> np.ndarray:
        """Per-frame NR scores for full-size float frames (N, H, W, 3)."""
        r256, r224 = self.prep_frames(frames)
        return batched_map(lambda a, b: self.step_batch(a, b).cpu().numpy(),
                           (r256, r224), self.batch_size)


def load_nr_model(args) -> NRModel:
    """The NR model of the CLI flags: the decoder and α/β from --nr-ckpt,
    VGG, ViT and JBU from their backbone flags (random with a warning when
    absent)."""
    if not args.nr_ckpt:
        raise SystemExit("--nr needs --nr-ckpt (a reference-layout NR .pth)")
    cfg = NRModelConfig(
        version=args.nr_version,
        refine_up_depth=args.refine_up_depth,
        transformer_decoder_depth=args.transformer_decoder_depth,
        dists=DISTSConfig(compute_dtype="float32" if args.fp32 else "bfloat16",
                          stats_impl="eager" if args.fp32 else "kernel"),
    )
    try:
        decoder_sd, alpha_beta = pretrained.load_nr_torch_file(args.nr_ckpt)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    render, sem = NR_SIZES
    vit = pretrained.resolve_vit_params(args.vit_ckpt, depth=args.vit_depth,
                                        grid_size=sem // 14)
    weights = (weights_from_arrays(*alpha_beta, cfg.dists) if alpha_beta
               else pretrained.resolve_dists_weights(cfg.dists, args.dists_weights))
    return NRModel(
        pretrained.resolve_vgg_params(args.vgg_ckpt), weights, cfg, vit=vit,
        jbu=pretrained.resolve_jbu_params(args.jbu_ckpt, dim=vit.embed_dim),
        decoder=NRDecoder.from_state_dict(decoder_sd, cfg, vit.embed_dim),
        render_size=render, sem_size=sem)


def _score_nr(args) -> int:
    """No-reference scoring CLI path (see NRScorer)."""
    if args.dist.endswith((".mp4", ".mov")):
        raise SystemExit(f"{args.dist}: {MP4_TODO}")
    frames = _load_frames(args.dist, resize=False, keep_aspect=False)
    out = NRScorer(load_nr_model(args), args.batch_size,
                   args.device).score_frames(frames)
    n = len(out)
    if args.out_csv:
        rows = [f"{i},{out[i]:.6f}" for i in range(n)]
        with open(args.out_csv, "w") as f:
            f.write("frame,nr_score\n" + "\n".join(rows) + "\n")
    summary = {"nr": {"video_score": round(float(out.mean()), 6), "frames": n}}
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"nr: {summary['nr']['video_score']:.4f}  "
              f"(mean of {n} frame scores)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="DISTS scoring for image pairs or frame directories, "
                    "NR scoring for renders alone"
    )
    p.add_argument("--ref", default=None,
                   help="reference image or frame directory")
    p.add_argument("--dist", required=True,
                   help="distorted image or frame directory")
    p.add_argument("--nr", action="store_true",
                   help="no-reference mode: score renders with an NR v8 "
                        "model (needs --nr-ckpt)")
    p.add_argument("--nr-ckpt", default=None,
                   help="reference-layout NR checkpoint (.pth)")
    p.add_argument("--nr-version", type=int, default=8)
    p.add_argument("--refine-up-depth", type=int, default=2)
    p.add_argument("--transformer-decoder-depth", type=int, default=2)
    p.add_argument("--vit-depth", type=int, default=12)
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
        return _score_nr(args)
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

    dtype = "float32" if args.fp32 else "bfloat16"
    model = pretrained.resolve_vgg_params(args.vgg_ckpt)
    results: dict[str, np.ndarray] = {}
    if args.metric in ("dists", "both"):
        cfg = DISTSConfig(compute_dtype=dtype,
                          stats_impl="eager" if args.fp32 else "kernel")
        weights = pretrained.resolve_dists_weights(cfg, args.dists_weights)
        scorer = FrameScorer(model, weights, cfg, resize_to=None,
                             device=args.device)
        results["dists"] = scorer.score_frames(dist, ref, batch_size=bs)
    if args.metric in ("adists", "both"):
        acfg = ADISTSConfig(compute_dtype=dtype)
        model = model.to(resolve_device(args.device)).eval()
        results["adists"] = batched_map(
            lambda d, r: adists_batch(model, d, r, acfg).cpu().numpy(),
            (dist, ref), bs)

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
