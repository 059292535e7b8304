"""Batched frame/video DISTS scoring — the port's serving path.

Counterpart of ``nerf_qa_tpu/eval/video_scorer.py``. Reference behaviour:
the per-video test loops of run_test2.py:278-297 and train-nr.py:305-315
(score every frame pair, mean-pool to a video score).

One step per fixed-shape batch: uint8 NHWC frames -> bilinear resize with
the 1/255 scale folded in (bf16 matmuls on the serving path) -> VGG
pyramid -> statistics (eager, or the fused CUDA moments kernel) ->
per-frame scores. Tail frames are padded, never dropped, and masked out:
a video's score is the mean of exactly its real frames.

Over a mesh (``parallel/mesh.py``) each data shard scores its rows on its
device and the scores return in frame order: the moments kernel launches
six times a shard. ``spatial=True`` is the full-resolution mode: frame
height split over the mesh's model axis as well
(``parallel/spatial.spatial_dists_forward``, six launches a slab).
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import numpy as np
import torch

from nerf_qa_torch.config import DISTSConfig, resolve_device, true_fp32
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.ops.resize import resize_bilinear, resize_bilinear_aa
from nerf_qa_torch.parallel import mesh as meshlib
from nerf_qa_torch.utils.profiling import span


def _prep(frames: torch.Tensor, out_hw: tuple[int, int] | None,
          fast: bool = False, antialias: bool = False) -> torch.Tensor:
    """Frames (uint8 or float in [0, 1]) -> fp32 NHWC in [0, 1] at
    ``out_hw`` (None: input resolution), in the span ``fr.prep``."""
    with span("fr.prep"):
        scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
        if out_hw is not None and tuple(frames.shape[1:3]) != tuple(out_hw):
            if antialias:
                return resize_bilinear_aa(frames.float() * scale, *out_hw)
            if fast:
                # serving path: bf16 matmul resize with folded normalisation
                return resize_bilinear(frames, out_hw[0], out_hw[1],
                                       compute_dtype=torch.bfloat16, scale=scale)
            return resize_bilinear(frames, out_hw[0], out_hw[1], scale=scale)
        x = frames.float()
        return x * scale if scale != 1.0 else x


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
            sl = [meshlib.pad_tail(a, batch_size - (hi - lo)) for a in sl]
        out[lo:hi] = np.asarray(fn(*sl))[: hi - lo]
    return out


class FrameScorer:
    """DISTS frame scorer on one device or over a mesh.

    Args:
      model: the VGG16 pyramid (``compat.pretrained.resolve_vgg_params``).
      weights: DISTSWeights (pretrained α/β by default elsewhere).
      cfg: DISTSConfig — the default, compute_dtype='bfloat16' +
        stats_impl='kernel', is the fast serving config (the moments
        kernel on the card, its plain sums for CPU tensors); fp32 + eager
        is the parity oracle.
      resize_to: target (H, W) before scoring, or None to score at input
        resolution (full-size mode).
      antialias: resize with the antialiased bilinear resizer
        (``ops.resize.resize_bilinear_aa``) instead of the plain one.
      mesh: a ``parallel.mesh.Mesh``: batches split over its data axis,
        each shard scored on its device (batch sizes rounded up to a
        multiple of the data axis by ``score_frames``).
      spatial: additionally split frame HEIGHT over the mesh's model axis
        (``parallel.spatial``): the full-resolution mode. Needs ``mesh``
        and ``resize_to=None``; frames need H % (model axis · 16) == 0 and
        W % 16 == 0.
      device: where to run without a mesh; None means the card, and raises
        without one. With a mesh, scores gather on its first device.
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
        if spatial:
            if mesh is None:
                raise ValueError("spatial=True requires a mesh")
            if resize_to is not None:
                raise ValueError(
                    "spatial=True is the full-resolution mode; use "
                    "resize_to=None (resize would cross device slabs)")
        self.mesh = mesh
        self.spatial = spatial
        self.device = mesh.primary if mesh is not None else resolve_device(device)
        self.model = model.to(self.device).eval()
        self.weights = weights.to(self.device)
        self.cfg = cfg
        self.resize_to = resize_to
        self.antialias = antialias
        if mesh is not None:
            self._models = meshlib.replicate(mesh, self.model)
            self._weights = meshlib.replicate(mesh, self.weights)

    def score_batch(self, dist_frames, ref_frames) -> torch.Tensor:
        """Per-frame scores (a device tensor) for one batch; numpy arrays
        and tensors on any device are accepted. Runs in the span
        ``fr.score``."""
        fast = self.cfg.compute_dtype == "bfloat16"
        # the fp32 path resizes and convolves in true fp32 (no TF32)
        precision = contextlib.nullcontext() if fast else true_fp32()
        with torch.no_grad(), precision, span("fr.score"):
            if self.mesh is None:
                return self._score(self.model, self.weights, self.device,
                                   dist_frames, ref_frames, fast)
            if self.spatial:
                from nerf_qa_torch.parallel.spatial import spatial_dists_forward

                x = _prep(meshlib.to_device(dist_frames, self.device), None)
                y = _prep(meshlib.to_device(ref_frames, self.device), None)
                return spatial_dists_forward(self._models, self.weights, x, y,
                                             self.mesh, self.cfg)
            shards = meshlib.shard_batch(self.mesh, (dist_frames, ref_frames))
            return torch.cat([
                self._score(self._models[dev], self._weights[dev], dev, d, r,
                            fast).to(self.device)
                for dev, (d, r) in zip(self.mesh.data_devices, shards)])

    def _score(self, model, weights, device, dist_frames, ref_frames,
               fast: bool) -> torch.Tensor:
        frames = (dist_frames, ref_frames)
        with span("fr.h2d", lambda: meshlib.host_copy(frames, device)):
            d = meshlib.to_device(dist_frames, device)
            r = meshlib.to_device(ref_frames, device)
        x = _prep(d, self.resize_to, fast, self.antialias)
        y = _prep(r, self.resize_to, fast, self.antialias)
        return dists.forward(model, weights, x, y, self.cfg)

    def score_frames(self, dist_frames, ref_frames,
                     batch_size: int = 32) -> np.ndarray:
        """Score N frame pairs, padding the tail batch (masked out)."""
        if ref_frames.shape[0] != dist_frames.shape[0]:
            raise ValueError("frame count mismatch")
        if self.mesh is not None:
            batch_size = meshlib.pad_to_multiple(
                batch_size, self.mesh.shape[meshlib.DATA_AXIS])
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
