"""Batched frame/video DISTS scoring — the port's serving path.

Counterpart of ``nerf_qa_tpu/eval/video_scorer.py``. Reference behaviour:
the per-video test loops of run_test2.py:278-297 and train-nr.py:305-315
(score every frame pair, mean-pool to a video score).

One step per fixed-shape batch: uint8 NHWC frames -> bilinear resize with
the 1/255 scale folded in (bf16 matmuls on the serving path) -> VGG
pyramid -> statistics (eager, or the fused CUDA moments kernel) ->
per-frame scores. Tail frames are padded, never dropped, and masked out:
a video's score is the mean of exactly its real frames.
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import numpy as np
import torch

from nerf_qa_torch.config import DISTSConfig, resolve_device, true_fp32
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.ops.resize import resize_bilinear

_PARALLEL_TODO = ("multi-device scoring is not yet ported (ROADMAP Queue 1 "
                  "item 14, parallel/)")


def _prep(frames: torch.Tensor, out_hw: tuple[int, int] | None,
          fast: bool = False) -> torch.Tensor:
    """Frames (uint8 or float in [0, 1]) -> fp32 NHWC in [0, 1] at
    ``out_hw`` (None: input resolution)."""
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    if out_hw is not None and tuple(frames.shape[1:3]) != tuple(out_hw):
        if fast:
            # serving path: bf16 matmul resize with folded normalisation
            return resize_bilinear(frames, out_hw[0], out_hw[1],
                                   compute_dtype=torch.bfloat16, scale=scale)
        return resize_bilinear(frames, out_hw[0], out_hw[1], scale=scale)
    x = frames.float()
    return x * scale if scale != 1.0 else x


def _pad_tail(a, pad: int):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)])


def batched_map(fn, arrays, batch_size: int) -> np.ndarray:
    """Run ``fn(*slices) -> (batch_size,)`` over equal-length arrays (numpy
    or torch) in fixed-shape batches, padding the tail by repeating the
    last row and unpadding the result."""
    n = arrays[0].shape[0]
    out = np.empty((n,), np.float32)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        sl = [a[lo:hi] for a in arrays]
        if hi - lo < batch_size:
            sl = [_pad_tail(a, batch_size - (hi - lo)) for a in sl]
        out[lo:hi] = np.asarray(fn(*sl))[: hi - lo]
    return out


class FrameScorer:
    """DISTS frame scorer on one device.

    Args:
      model: the VGG16 pyramid (``compat.pretrained.resolve_vgg_params``).
      weights: DISTSWeights (pretrained α/β by default elsewhere).
      cfg: DISTSConfig — the default, compute_dtype='bfloat16' +
        stats_impl='kernel', is the fast serving config (the moments
        kernel on the card, its plain sums for CPU tensors); fp32 + eager
        is the parity oracle.
      resize_to: target (H, W) before scoring, or None to score at input
        resolution (full-size mode).
      antialias: the antialiased resizer; not yet ported.
      mesh, spatial: multi-device scoring; not yet ported.
      device: where to run; None means the card, and raises without one.
    """

    def __init__(
        self,
        model: VGG16Pyramid,
        weights: dists.DISTSWeights,
        cfg: DISTSConfig = DISTSConfig(compute_dtype="bfloat16",
                                       stats_impl="kernel"),
        resize_to: tuple[int, int] | None = (256, 256),
        antialias: bool = False,
        mesh=None,
        spatial: bool = False,
        device: str | torch.device | None = None,
    ):
        if mesh is not None or spatial:
            raise NotImplementedError(_PARALLEL_TODO)
        if antialias:
            raise NotImplementedError(
                "the antialiased resize is not yet ported (ROADMAP Queue 1 "
                "item 2)")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.weights = weights.to(self.device)
        self.cfg = cfg
        self.resize_to = resize_to

    def score_batch(self, dist_frames, ref_frames) -> torch.Tensor:
        """Per-frame scores (a device tensor) for one batch; numpy arrays
        and tensors on any device are accepted."""
        fast = self.cfg.compute_dtype == "bfloat16"
        d = torch.as_tensor(dist_frames).to(self.device, non_blocking=True)
        r = torch.as_tensor(ref_frames).to(self.device, non_blocking=True)
        # the fp32 path resizes and convolves in true fp32 (no TF32)
        precision = contextlib.nullcontext() if fast else true_fp32()
        with torch.no_grad(), precision:
            x = _prep(d, self.resize_to, fast)
            y = _prep(r, self.resize_to, fast)
            return dists.forward(self.model, self.weights, x, y, self.cfg)

    def score_frames(self, dist_frames, ref_frames,
                     batch_size: int = 32) -> np.ndarray:
        """Score N frame pairs, padding the tail batch (masked out)."""
        if ref_frames.shape[0] != dist_frames.shape[0]:
            raise ValueError("frame count mismatch")
        return batched_map(
            lambda d, r: self.score_batch(d, r).cpu().numpy(),
            (dist_frames, ref_frames), batch_size)

    def score_video(self, dist_frames, ref_frames, batch_size: int = 32) -> float:
        """Video-level score = mean of per-frame scores
        (train-nr.py:314-315 semantics)."""
        return float(self.score_frames(dist_frames, ref_frames, batch_size).mean())

    def score_videos(
        self,
        pairs: Iterable[tuple[np.ndarray, np.ndarray]],
        batch_size: int = 32,
    ) -> list[float]:
        return [self.score_video(d, r, batch_size) for d, r in pairs]
