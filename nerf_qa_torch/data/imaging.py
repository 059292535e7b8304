"""Host-side image decode, resize and paired augmentation.

Counterpart of ``nerf_qa_tpu/data/imaging.py``: PIL decode with
RGBA->white compositing (data.py:64-84), torch-geometry bilinear resize,
``load_resized`` and ``load_prepared`` (DISTS_pt.py:210-217), and the
paired random resize and crop of the FR augmentation (data.py:315-325)
and rotation of the NR one (data.py:508-513), with every random number
from an explicit numpy Generator.

``load_resized`` and ``load_prepared`` (square-256 policy) decode through
the native C++ layer (``data/native.py``) when it builds, and through PIL
otherwise. A native error on a file falls back to PIL, as in the JAX
package, but is counted: ``pil_fallbacks`` is the number of such
fallbacks taken while the library was available (0 on a healthy feed).
"""
from __future__ import annotations

import math
import os

import numpy as np

from nerf_qa_torch.data import native

# PIL decodes taken because the native library raised on a file while it
# was available (load_resized, load_prepared)
pil_fallbacks = 0


def fast_decode_enabled() -> bool:
    """Opt-in DCT-scaled JPEG decode for the feed paths
    (``NERF_QA_TORCH_FAST_DECODE=1``): the native layer decodes JPEGs at
    the largest 1/{2,4,8} DCT scale that still covers the target before
    the bilinear resize; PNG is unaffected.

    Scoring caveat: the DCT scale is an antialiased downsample, whereas
    the reference's bilinear-from-full-resolution (data.py:81-82,
    DISTS_pt.py:212) aliases, so per-pixel noise is attenuated through
    the fast path. The JAX package measured a σ=0.05 noise pair at 1080p
    scoring DISTS 0.0023 exact against 0.0002 fast (its own measurement,
    nerf_qa_tpu/data/imaging.py). Use it only where both sides of every
    pair take the same path and distortions are low-frequency; never for
    reference-parity scoring. Off by default for that reason."""
    return os.environ.get("NERF_QA_TORCH_FAST_DECODE", "0") == "1"


try:
    from PIL import Image

    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to float32 HWC RGB in [0,1]; RGBA composites onto white
    (data.py:64-84)."""
    if not _HAVE_PIL:
        raise RuntimeError("PIL unavailable; build the native decoder")
    img = Image.open(path)
    if img.mode == "RGBA":
        bg = Image.new("RGBA", img.size, (255, 255, 255))
        bg.paste(img, mask=img.split()[3])
        img = bg.convert("RGB")
    else:
        img = img.convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def resize_image(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize, align_corners=False, no antialias — matches torch
    F.interpolate (host-side twin of ops/resize.resize_bilinear)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.astype(np.float32)

    def weights(in_size, out_size):
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0, in_size - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        t = (src - lo).astype(np.float32)
        return lo, hi, t

    x = img.astype(np.float32)
    lo, hi, t = weights(h, out_h)
    x = x[lo] * (1 - t)[:, None, None] + x[hi] * t[:, None, None]
    lo, hi, t = weights(w, out_w)
    x = x[:, lo] * (1 - t)[None, :, None] + x[:, hi] * t[None, :, None]
    return x


def _count_fallback() -> None:
    global pil_fallbacks
    pil_fallbacks += 1


def load_resized(path: str, out_h: int, out_w: int) -> np.ndarray:
    """Fused decode+resize to float32 (out_h, out_w, 3): the native layer
    when it builds (same numerics as the PIL route, held by
    tests/test_torch_native_decoder.py), PIL otherwise."""
    if native.available():
        try:
            return native.decode_resize(path, out_h, out_w,
                                        fast=fast_decode_enabled())
        except (IOError, RuntimeError):
            _count_fallback()
    return resize_image(load_image_rgb(path), out_h, out_w)


def resize_shortest_side(img: np.ndarray, side: int) -> np.ndarray:
    """Aspect-preserving resize (prepare_image keep_aspect_ratio path,
    DISTS_pt.py:212-213): shortest side -> ``side``."""
    h, w = img.shape[:2]
    if h <= w:
        return resize_image(img, side, max(1, round(w * side / h)))
    return resize_image(img, max(1, round(h * side / w)), side)


def prepare_image(img: np.ndarray, resize: bool = True,
                  keep_aspect_ratio: bool = False) -> np.ndarray:
    """DISTS input prep (DISTS_pt.py:210-217): resize only when the
    shortest side exceeds 256."""
    h, w = img.shape[:2]
    if resize and min(h, w) > 256:
        if keep_aspect_ratio:
            return resize_shortest_side(img, 256)
        return resize_image(img, 256, 256)
    return img.astype(np.float32)


def load_prepared(path: str, resize: bool = True,
                  keep_aspect_ratio: bool = False) -> np.ndarray:
    """Decode + prepare_image in one step. For the square-256 policy the
    native layer decodes and resizes without a PIL round trip when it
    builds (the FR loaders' hot path; same numerics)."""
    if resize and not keep_aspect_ratio and native.available():
        try:
            h, w = native.image_size(path)
            if min(h, w) > 256:
                return native.decode_resize(path, 256, 256,
                                            fast=fast_decode_enabled())
            return native.decode_resize(path, h, w)
        except (IOError, RuntimeError):
            _count_fallback()
    return prepare_image(load_image_rgb(path), resize=resize,
                         keep_aspect_ratio=keep_aspect_ratio)


def paired_random_resize(a: np.ndarray, b: np.ndarray, min_side: int,
                         rng: np.random.Generator):
    """Resize both images so the shortest side is uniform in
    [min_side, current_min_side] (data.py:315-320)."""
    h, w = a.shape[:2]
    lo = min(min_side, min(h, w))
    target = int(rng.integers(lo, min(h, w) + 1))
    scale = target / min(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    return resize_image(a, nh, nw), resize_image(b, nh, nw)


def paired_random_crop(a: np.ndarray, b: np.ndarray, ch: int, cw: int,
                       rng: np.random.Generator):
    """Same random crop applied to both images (data.py:321-325)."""
    h, w = a.shape[:2]
    ch, cw = min(ch, h), min(cw, w)
    i = int(rng.integers(0, h - ch + 1))
    j = int(rng.integers(0, w - cw + 1))
    return a[i:i + ch, j:j + cw], b[i:i + ch, j:j + cw]


def paired_rotate(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate about the center, zero fill — torchvision TF.rotate
    semantics (data.py:511-513), by inverse mapping with bilinear
    sampling; the caller applies one angle to both images of a pair."""
    h, w = img.shape[:2]
    theta = math.radians(angle_deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ys = (yy - cy) * math.cos(theta) - (xx - cx) * math.sin(theta) + cy
    xs = (yy - cy) * math.sin(theta) + (xx - cx) * math.cos(theta) + cx
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    ty = (ys - y0)[..., None]
    tx = (xs - x0)[..., None]
    out = (
        img[y0, x0] * (1 - ty) * (1 - tx)
        + img[y1, x0] * ty * (1 - tx)
        + img[y0, x1] * (1 - ty) * tx
        + img[y1, x1] * ty * tx
    )
    return np.where(valid[..., None], out, 0.0).astype(np.float32)
