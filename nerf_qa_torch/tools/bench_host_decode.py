"""Host-side feed-rate benchmark: can the data plane feed the card?

Counterpart of ``nerf_qa_tpu/tools/bench_host_decode.py``. The reference
feeds its GPU from 4-5 PIL/cv2 DataLoader workers (nerf_qa/data.py:174-188);
the port's equivalent is the native C++ decode+resize pool
(``data/native.py``). This tool measures what the host sustains:

* ``fps_host_decode``: decode+resize throughput of the native pool on
  synthetic 1080p JPEG and PNG fixtures (-> 256² float32), across thread
  counts (each count has its own pool), exact and, for JPEG, with the
  DCT-scaled fast decode.
* ``fps_overlapped``: decode of batch N+1 on a host thread overlapped
  with the device's DISTS step on batch N (the double-buffered prefetch
  pattern), through ``FrameScorer`` on ``--device`` (default: the GPU).

Where the native library does not build (no g++ or no libjpeg/libpng
headers on the host), every rate is taken through the route the loaders
then take, ``data/imaging.load_resized`` (PIL decode and the numpy
resize), one call per frame on a pool of threads, and ``decoder`` says
``"pil"`` with the build failure's reason.

Usage: python -m nerf_qa_torch.tools.bench_host_decode [--frames 32]
       [--threads 1,2,4,8] [--overlap] [--device cpu] [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nerf_qa_torch.data import imaging, native


def make_fixtures(root: str, n: int, h: int = 1080, w: int = 1920,
                  codec: str = "jpeg") -> list[str]:
    """n distinct synthetic frames (gradient + noise texture — JPEG
    entropy comparable to rendered content, not flat fields)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1)
    paths = []
    for i in range(n):
        img = np.clip(base * 0.7 + rng.normal(0.15, 0.08, (h, w, 3)), 0, 1)
        arr = (img * 255).astype(np.uint8)
        ext = "jpg" if codec == "jpeg" else "png"
        p = os.path.join(root, f"frame_{i:04d}.{ext}")
        if codec == "jpeg":
            Image.fromarray(arr).save(p, quality=90)
        else:
            Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def decode_batch(paths: list[str], out_h: int, out_w: int, threads: int,
                 fast: bool = False) -> np.ndarray:
    """(N, out_h, out_w, 3) float32: the native pool when the library
    builds, else ``imaging.load_resized`` (PIL) on ``threads`` threads."""
    if native.available():
        return native.decode_resize_batch(paths, out_h, out_w,
                                          threads=threads, fast=fast)
    with ThreadPoolExecutor(threads) as pool:
        return np.stack(list(pool.map(
            lambda p: imaging.load_resized(p, out_h, out_w), paths)))


def bench_decode(paths: list[str], threads: int, out_hw=(256, 256),
                 reps: int = 3, fast: bool = False) -> float:
    """frames/s of ``decode_batch`` on ``paths``. fast=True uses the
    DCT-scaled JPEG decode (data/native.decode_resize docstring) — the
    NERF_QA_TORCH_FAST_DECODE=1 feed path."""
    decode_batch(paths[:2], *out_hw, threads, fast)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        decode_batch(paths, *out_hw, threads, fast)
    return len(paths) * reps / (time.perf_counter() - t0)


def bench_overlapped(paths: list[str], threads: int, batch: int = 16,
                     iters: int = 6, device=None) -> float:
    """Decode batch N+1 on a host thread while the device scores batch N
    (pipelined producer/consumer; one queue slot = double buffering)."""
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_vgg_params,
    )
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.eval.video_scorer import FrameScorer

    cfg = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
    scorer = FrameScorer(resolve_vgg_params(seed=0), resolve_dists_weights(cfg),
                         cfg, resize_to=None, device=device)

    def decode(i):
        sel = [paths[(i * batch + j) % len(paths)] for j in range(batch)]
        return decode_batch(sel, 256, 256, threads)

    x0 = decode(0)
    scorer.score_batch(x0, x0).cpu()  # warm-up

    q: queue.Queue = queue.Queue(maxsize=1)

    def producer():
        for i in range(iters):
            q.put(decode(i))
        q.put(None)

    t = threading.Thread(target=producer)
    t0 = time.perf_counter()
    t.start()
    out = None
    while (b := q.get()) is not None:
        out = scorer.score_batch(b, b)
    out.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    t.join()
    return batch * iters / dt


def run(frames: int = 32, threads=(1, 2, 4, 8), overlap: bool = False,
        frames_dir: str | None = None, device=None) -> dict:
    built = native.available()
    result: dict = {"host_cores": os.cpu_count(),
                    "decoder": "native" if built else "pil"}
    if not built:
        result["native_unavailable"] = native.unavailable_reason()
    with tempfile.TemporaryDirectory() as tmp:
        for codec in ("jpeg", "png"):
            if frames_dir:
                paths = sorted(
                    os.path.join(frames_dir, f) for f in os.listdir(frames_dir)
                )[:frames]
                if not paths:
                    continue
            else:
                paths = make_fixtures(tmp, frames, codec=codec)
            for t in threads:
                result[f"fps_host_decode_{codec}_t{t}"] = round(
                    bench_decode(paths, t), 2)
            if codec == "jpeg" and built:
                for t in threads:
                    result[f"fps_host_decode_jpeg_fast_t{t}"] = round(
                        bench_decode(paths, t, fast=True), 2)
            if frames_dir:
                break
        if overlap:
            paths = make_fixtures(tmp, frames, codec="jpeg")
            result["fps_overlapped"] = round(
                bench_overlapped(paths, threads[-1], device=device), 2)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="host decode feed-rate bench")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--threads", default="1,2,4,8")
    p.add_argument("--frames-dir", default=None,
                   help="bench real frames instead of synthetic fixtures")
    p.add_argument("--overlap", action="store_true",
                   help="also measure decode/score overlapped fps")
    p.add_argument("--device", default=None,
                   help="torch device of --overlap (default: the GPU)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    res = run(args.frames, tuple(int(t) for t in args.threads.split(",")),
              overlap=args.overlap, frames_dir=args.frames_dir,
              device=args.device)
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
