"""Pseudo-reference retrieval + certainty-masked DISTS scoring, on the GPU.

Counterpart of ``nerf_qa_tpu/eval/retrieval.py``. Reference behavior:
nerf_qa/image_retrieval.py — SIFT bag-of-words retrieval (:7-61) and RoMa
dense warping of the retrieved reference onto the render with
certainty-masked DISTS pseudo-FR scoring (:144-219). That module is dead
code in the reference (it imports a missing ``nerf_qa.roma``); the JAX
package rebuilt the capability, and this is its port:

* Retrieval: images embed through the VGG16 pyramid — per-stage
  spatial-mean descriptors, L2-normalised and concatenated; cosine
  similarity over the index is one matmul, ranked on the host.
* Warped scoring: the reference is warped onto the render by a dense
  grid and DISTS statistics are certainty-weighted moments, so unmatched
  regions do not perturb means and variances. They stay plain torch: the
  moments kernel computes unweighted sums.
* Dense correspondence: ``estimate_warp`` correlates mean-centred,
  normalised VGG stage features all-pairs, takes each query's hard
  argmax refined by a local 3x3 soft-argmax, and keeps the correlation
  peak as the certainty map. ``pseudo_fr_score`` chains estimate -> warp
  -> certainty-masked DISTS.

The grid and certainty resizes are antialiased bilinear
(``ops.resize.resize_bilinear_aa``), as ``jax.image.resize(..., "linear")``
is when it shrinks.
"""
from __future__ import annotations

import numpy as np
import torch

from nerf_qa_torch.config import DISTSConfig, torch_dtype, true_fp32
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.ops.resize import resize_bilinear_aa


def embed_images(vgg: VGG16Pyramid, images: torch.Tensor,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N,H,W,3) -> L2-normalized (N, 1475) fp32 pyramid-mean descriptors.
    The means and the norm are fp32 whatever the pyramid's dtype: a unit
    vector rounded to bf16 (as the JAX function returns it) is up to ~4e-3
    off unit length, more than the cosines of two similar images differ,
    and an image then fails to retrieve itself."""
    feats = vgg(images, compute_dtype)
    pooled = torch.cat([f.float().mean(dim=(1, 2)) for f in feats], dim=-1)
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)


class ImageRetrieval:
    """Cosine-similarity retrieval over a reference image corpus
    (ImageRetrieval.retrieve equivalent, image_retrieval.py:47-61). The
    corpus and queries are numpy NHWC arrays; they go to ``vgg``'s device
    a batch at a time."""

    def __init__(self, vgg: VGG16Pyramid, compute_dtype: torch.dtype = torch.bfloat16):
        self.vgg = vgg
        self.compute_dtype = compute_dtype
        self.device = next(vgg.parameters()).device
        self.index: np.ndarray | None = None

    def _embed(self, images: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            e = embed_images(self.vgg, torch.as_tensor(images, device=self.device),
                             self.compute_dtype)
        return e.float().cpu().numpy()

    def build_index(self, images: np.ndarray, batch_size: int = 16) -> None:
        chunks = [self._embed(images[lo:lo + batch_size])
                  for lo in range(0, len(images), batch_size)]
        self.index = np.concatenate(chunks, axis=0)

    def retrieve(self, queries: np.ndarray, k: int = 1):
        """Top-k (indices, similarities) for each query image."""
        if self.index is None:
            raise RuntimeError("build_index first")
        q = self._embed(queries)
        sims = q @ self.index.T  # (Q, N)
        top = np.argsort(-sims, axis=1)[:, :k]
        return top, np.take_along_axis(sims, top, axis=1)


def warp_image(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear warp: grid (N,H,W,2) holds source (y, x) pixel coords."""
    n, h, w, c = image.shape
    ys = grid[..., 0].clamp(0, h - 1)
    xs = grid[..., 1].clamp(0, w - 1)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    y0 = y0f.long()
    x0 = x0f.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ty = (ys - y0f)[..., None]
    tx = (xs - x0f)[..., None]
    batch = torch.arange(n, device=image.device)[:, None, None]

    def gather(yy, xx):
        return image[batch, yy, xx]

    return (
        gather(y0, x0) * (1 - ty) * (1 - tx)
        + gather(y1, x0) * ty * (1 - tx)
        + gather(y0, x1) * (1 - ty) * tx
        + gather(y1, x1) * ty * tx
    )


def estimate_warp(
    vgg: VGG16Pyramid,
    render: torch.Tensor,
    reference: torch.Tensor,
    stage: int = 3,
    temperature: float = 0.01,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse dense correspondence render -> reference.

    All-pairs cosine correlation of spatially mean-centred, L2-normalised
    VGG ``stage`` features (stride 2^(stage-1)) as one (Hq·Wq, Hs·Ws)
    matmul per image, then the hard argmax refined by a temperature
    softmax over its 3x3 neighbourhood. Mean-centring is load-bearing: VGG
    activations share a large common component across positions, so raw
    cosines saturate near 1. Returns (grid, certainty): grid (N,H,W,2)
    holds source (y, x) PIXEL coords into ``reference`` for every render
    pixel (ready for ``warp_image``); certainty (N,H,W) is the per-position
    peak correlation clipped to [0, 1] (feed it to ``masked_dists_score``).
    The matmul runs in true fp32."""
    n, h, w, _ = render.shape
    stride = 2 ** max(stage - 1, 0)
    both = vgg(torch.cat([render, reference]), compute_dtype)
    fq = both[stage][:n].float()
    fs = both[stage][n:].float()
    hq, wq, c = fq.shape[1], fq.shape[2], fq.shape[3]
    hs, ws = fs.shape[1], fs.shape[2]

    def norm(f):
        f = f - f.mean(dim=(1, 2), keepdim=True)
        return f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-8)

    q = norm(fq).reshape(n, hq * wq, c)
    s = norm(fs).reshape(n, hs * ws, c)
    with true_fp32():
        corr = torch.einsum("nqc,nsc->nqs", q, s)  # cosine in [-1, 1]

    # hard argmax + LOCAL 3x3 soft-argmax refinement: a global softmax
    # lets the long tail of distant cells bias the expectation by O(1)
    # feature cells; the peak's neighbourhood keeps sub-cell precision
    am = corr.argmax(dim=-1)  # (N, Q) flat source index
    am_y = am // ws
    am_x = am % ws
    offs = torch.tensor([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=render.device)  # (9, 2)
    ny = (am_y[..., None] + offs[:, 0]).clamp(0, hs - 1)  # (N, Q, 9)
    nx = (am_x[..., None] + offs[:, 1]).clamp(0, ws - 1)
    local = torch.take_along_dim(corr, ny * ws + nx, dim=-1)  # (N, Q, 9)
    p = torch.softmax(local / temperature, dim=-1)
    ref_y = (p * ny).sum(-1)
    ref_x = (p * nx).sum(-1)
    grid_feat = torch.stack([ref_y, ref_x], dim=-1).reshape(n, hq, wq, 2)
    cert_feat = corr.max(dim=-1).values.reshape(n, hq, wq, 1)

    # feature-grid coords -> full-res pixel coords (cell centres)
    grid_feat = (grid_feat + 0.5) * stride - 0.5
    grid = resize_bilinear_aa(grid_feat, h, w)
    certainty = resize_bilinear_aa(cert_feat, h, w)[..., 0].clamp(0.0, 1.0)
    return grid, certainty


def pseudo_fr_score(
    vgg: VGG16Pyramid,
    weights: dists.DISTSWeights,
    render: torch.Tensor,
    reference: torch.Tensor,
    cfg: DISTSConfig = DISTSConfig(),
    stage: int = 3,
    certainty_threshold: float = 0.0,
) -> torch.Tensor:
    """End-to-end pseudo-FR scoring of a render against a RETRIEVED (not
    pixel-aligned) reference: estimate_warp -> warp_image ->
    certainty-masked DISTS (image_retrieval.py:144-219, rebuilt alive).
    ``certainty_threshold`` optionally gates low-confidence pixels to zero
    weight."""
    grid, certainty = estimate_warp(vgg, render, reference, stage=stage)
    warped = warp_image(reference, grid)
    if certainty_threshold > 0.0:
        certainty = torch.where(certainty >= certainty_threshold, certainty,
                                torch.zeros_like(certainty))
    return masked_dists_score(vgg, weights, render, warped, certainty, cfg)


def masked_stage_stats(fx: torch.Tensor, fy: torch.Tensor,
                       weight: torch.Tensor) -> dists.StageStats:
    """Certainty-weighted spatial moments: weight (N,H,W,1) in [0,1]."""
    fx = fx.float()
    fy = fy.float()
    wsum = weight.sum(dim=(1, 2)) + 1e-8
    mean_x = (fx * weight).sum(dim=(1, 2)) / wsum
    mean_y = (fy * weight).sum(dim=(1, 2)) / wsum
    var_x = ((fx - mean_x[:, None, None, :]).square() * weight).sum(dim=(1, 2)) / wsum
    var_y = ((fy - mean_y[:, None, None, :]).square() * weight).sum(dim=(1, 2)) / wsum
    cov = (fx * fy * weight).sum(dim=(1, 2)) / wsum - mean_x * mean_y
    return dists.StageStats(mean_x, mean_y, var_x, var_y, cov)


def masked_dists_score(
    vgg: VGG16Pyramid,
    weights: dists.DISTSWeights,
    render: torch.Tensor,
    warped_reference: torch.Tensor,
    certainty: torch.Tensor,
    cfg: DISTSConfig = DISTSConfig(),
) -> torch.Tensor:
    """Certainty-masked pseudo-FR DISTS (image_retrieval.py:144-219
    behavior): score only where the warp is confident. certainty: (N,H,W)
    or (N,H,W,1) in [0,1], resized to each stage (antialiased bilinear)."""
    if certainty.dim() == 3:
        certainty = certainty[..., None]
    n = render.shape[0]
    both = vgg(torch.cat([render, warped_reference]), torch_dtype(cfg.compute_dtype))
    per_stage = []
    for f in both:
        h, w = f.shape[1], f.shape[2]
        cert = resize_bilinear_aa(certainty, h, w)
        per_stage.append(masked_stage_stats(f[:n], f[n:], cert))
    stats = torch.stack([
        torch.cat([s[i] for s in per_stage], dim=-1) for i in range(5)
    ])
    return dists.score_from_stats(stats, weights, cfg)
