"""Sustained end-to-end feed benchmark: host decode feeding the card.

Counterpart of ``nerf_qa_tpu/tools/bench_feed.py``. The reference feeds
its GPU with 4-worker PIL DataLoaders (nerf_qa/data.py:182); the port's
equivalent is the native C++ decode pool feeding a prefetch queue. This
tool measures what a scorer sustains over hundreds of frames, per feed
mode:

  dists_jpeg         native full JPEG decode of 1080p frame pairs ->
                     256^2 f32 -> device -> DISTS scores (FrameScorer,
                     bf16, the moments kernel)
  dists_jpeg_fast    same with the DCT-scaled fast decode
                     (the NERF_QA_TORCH_FAST_DECODE=1 feed path)
  dists_uint8_cache  one-time decode into an in-memory uint8 256^2
                     cache (Test2Dataset's cache mode,
                     reference data.py:126-143), then a sustained feed
                     from the cache
  nr_tokens          render-only 256^2 decode + fp16 ViT-token cache
                     gather (the --feature-cache path,
                     data/feature_cache.py) -> NR v8 scores
  nr_full            render 256^2 + 224^2 decode -> NR v8 scores (the
                     ViT runs on the device)

Decode work cycles a pool of distinct 1080p JPEG fixtures. Where the
native library does not build, decodes go through ``imaging.load_resized``
(PIL) on a thread pool (``bench_host_decode.decode_batch``), ``decoder``
says so, and the fast mode is skipped. Emits a CUMULATIVE one-line JSON
to stdout after EVERY completed mode so a caller-imposed timeout keeps
the finished modes; progress lines go to stderr. ``--tiny`` runs every
mode at toy sizes (96x128 fixtures, NR at 64²/56² with a 1-block ViT).

Usage: python -m nerf_qa_torch.tools.bench_feed [--frames 512]
       [--modes dists_jpeg,...] [--device cpu] [--tiny] [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from nerf_qa_torch.data import native
from nerf_qa_torch.tools.bench_host_decode import decode_batch

MODES = ("dists_jpeg", "dists_jpeg_fast", "dists_uint8_cache", "nr_tokens",
         "nr_full")


def _log(msg: str) -> None:
    print(f"bench_feed: {msg}", file=sys.stderr, flush=True)


def _make_fixture_pairs(root: str, n_pairs: int, hw) -> tuple[list, list]:
    """n distinct (reference, distorted) JPEG pairs with rendered-content-
    like entropy (gradient + noise texture)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1)
    refs, dists_ = [], []
    for i in range(n_pairs):
        ref = np.clip(base * 0.7 + rng.normal(0.15, 0.08, (h, w, 3)), 0, 1)
        dst = np.clip(ref + rng.normal(0.0, 0.04, (h, w, 3)), 0, 1)
        rp = os.path.join(root, f"ref_{i:03d}.jpg")
        dp = os.path.join(root, f"dst_{i:03d}.jpg")
        Image.fromarray((ref * 255).astype(np.uint8)).save(rp, quality=90)
        Image.fromarray((dst * 255).astype(np.uint8)).save(dp, quality=90)
        refs.append(rp)
        dists_.append(dp)
    return refs, dists_


def _sustained(decode_batch_fn, step, n_batches: int, batch: int,
               sync_every: int = 4) -> float:
    """Producer thread decodes batch i+1 while the device scores batch i
    (the device_prefetch pattern); returns sustained frames/s including
    decode, H2D, and device compute."""
    q: queue.Queue = queue.Queue(maxsize=2)
    err: list = []

    def producer():
        try:
            for i in range(n_batches):
                q.put(decode_batch_fn(i))
        except Exception as e:  # surface decode failures to the consumer
            err.append(e)
        q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t0 = time.perf_counter()
    t.start()
    out = None
    done = 0
    while (b := q.get()) is not None:
        out = step(*b)
        done += 1
        if done % sync_every == 0:
            out.cpu()  # waits for the device
    if out is not None:
        out.cpu()
    dt = time.perf_counter() - t0
    t.join()
    if err:
        raise err[0]
    return batch * n_batches / dt


def run(frames: int = 512, n_pairs: int = 16, batch: int = 16,
        modes=MODES, tiny: bool = False, emit=None, device=None) -> dict:
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_vgg_params,
    )
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.eval.video_scorer import FrameScorer

    if tiny:
        frames, n_pairs, batch, hw, score_hw = 16, 2, 4, (96, 128), 64
    else:
        hw, score_hw = (1080, 1920), 256
    threads = os.cpu_count() or 1
    n_batches = max(1, frames // batch)
    frames = n_batches * batch
    built = native.available()

    result: dict = {
        "frames": frames, "batch": batch, "decode_threads": threads,
        "fixture_hw": list(hw), "score_size": score_hw,
        "host_cores": os.cpu_count(),
        "decoder": "native" if built else "pil",
    }
    if not built:
        result["native_unavailable"] = native.unavailable_reason()

    cfg = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
    vgg = resolve_vgg_params(seed=0)
    scorer = FrameScorer(vgg, resolve_dists_weights(cfg), cfg, resize_to=None,
                         device=device)

    with tempfile.TemporaryDirectory() as tmp:
        _log(f"building {n_pairs} fixture pairs at {hw[0]}x{hw[1]}")
        refs, dsts = _make_fixture_pairs(tmp, n_pairs, hw)

        def paths_for(i: int) -> tuple[list, list]:
            sel = [(i * batch + j) % n_pairs for j in range(batch)]
            return [refs[k] for k in sel], [dsts[k] for k in sel]

        def jpeg_batch(fast):
            def decode(i):
                rp, dp = paths_for(i)
                r = decode_batch(rp, score_hw, score_hw, threads, fast)
                d = decode_batch(dp, score_hw, score_hw, threads, fast)
                return d, r
            return decode

        scorer.score_batch(*jpeg_batch(False)(0)).cpu()  # warm-up

        def record(name: str, fps: float) -> None:
            result[f"fps_{name}"] = round(fps, 2)
            _log(f"{name}: {fps:.2f} fr/s")
            if emit:
                emit(result)

        if "dists_jpeg" in modes:
            record("dists_jpeg", _sustained(jpeg_batch(False),
                                            scorer.score_batch, n_batches, batch))
        if "dists_jpeg_fast" in modes and built:
            record("dists_jpeg_fast", _sustained(jpeg_batch(True),
                                                 scorer.score_batch, n_batches,
                                                 batch))
        if "dists_uint8_cache" in modes:
            t0 = time.perf_counter()
            ref_cache = (decode_batch(refs, score_hw, score_hw, threads)
                         * 255).astype(np.uint8)
            dst_cache = (decode_batch(dsts, score_hw, score_hw, threads)
                         * 255).astype(np.uint8)
            result["uint8_cache_build_s"] = round(time.perf_counter() - t0, 2)

            def cache_batch(i):
                sel = [(i * batch + j) % n_pairs for j in range(batch)]
                return dst_cache[sel], ref_cache[sel]

            scorer.score_batch(*cache_batch(0)).cpu()  # warm-up
            record("dists_uint8_cache", _sustained(cache_batch, scorer.score_batch,
                                                   n_batches, batch))

        nr_modes = [m for m in modes if m.startswith("nr_")]
        if nr_modes:
            _run_nr_modes(result, nr_modes, tiny, vgg, dsts, n_pairs, frames,
                          threads, record, scorer.device)
    return result


def _run_nr_modes(result: dict, modes, tiny: bool, vgg, dsts: list,
                  n_pairs: int, frames: int, threads: int, record,
                  device) -> None:
    """NR v8 serving feeds: full (ViT on device) vs cached-token gather.
    Random weights from seeds (same FLOPs as trained ones)."""
    from nerf_qa_torch.compat.pretrained import resolve_vit_params
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig
    from nerf_qa_torch.models.nr.model import NRModel

    if tiny:
        render, sem, depth, batch = 64, 56, 1, 4
    else:
        render, sem, depth, batch = 256, 224, 12, 8
    n_batches = max(1, frames // batch)
    grid = sem // 14
    cfg = NRModelConfig(
        transformer_decoder_depth=2, refine_up_depth=2, dropout_rate=0.2,
        decoder_dtype="bfloat16",
        dists=DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel"),
    )
    model = NRModel(vgg, cfg=cfg, render_size=render, sem_size=sem, seed=0,
                    vit=resolve_vit_params(depth=depth, grid_size=grid)
                    ).to(device).eval()
    result["nr_batch"] = batch

    def dev(a):
        return torch.as_tensor(a).to(device, non_blocking=True)

    def render_paths(i: int) -> list:
        return [dsts[(i * batch + j) % n_pairs] for j in range(batch)]

    if "nr_full" in modes:
        def decode_full(i):
            p = render_paths(i)
            return (decode_batch(p, render, render, threads),
                    decode_batch(p, sem, sem, threads))

        def step_full(r256, r224):
            with torch.no_grad():
                return model(dev(r256), dev(r224))

        step_full(*decode_full(0)).cpu()  # warm-up
        record("nr_full", _sustained(decode_full, step_full, n_batches, batch,
                                     sync_every=1))

    if "nr_tokens" in modes:
        # fabricated fp16 token cache, memmap-read like the real one
        # (data/feature_cache.py stores (n, gh, gw, 384) fp16 per video)
        rng = np.random.default_rng(0)
        with tempfile.TemporaryDirectory() as tmp:
            tok_path = os.path.join(tmp, "tokens.npy")
            np.save(tok_path, rng.normal(
                0, 1, (n_pairs, grid, grid, 384)).astype(np.float16))
            tok_map = np.load(tok_path, mmap_mode="r")
            r224_zero = torch.zeros((batch, sem, sem, 3), device=device)

            def decode_tok(i):
                p = render_paths(i)
                sel = [(i * batch + j) % n_pairs for j in range(batch)]
                toks = np.stack([np.asarray(tok_map[k], np.float32)
                                 for k in sel])
                return decode_batch(p, render, render, threads), toks

            def step_tok(r256, toks):
                with torch.no_grad():
                    return model(dev(r256), r224_zero, sem_tokens=dev(toks))

            step_tok(*decode_tok(0)).cpu()  # warm-up
            record("nr_tokens", _sustained(decode_tok, step_tok, n_batches,
                                           batch, sync_every=1))
            del tok_map


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sustained end-to-end feed")
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--pairs", type=int, default=16,
                   help="distinct fixture pairs cycled to --frames")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    def emit(res):
        if args.json:
            print(json.dumps(res), flush=True)

    res = run(frames=args.frames, n_pairs=args.pairs, batch=args.batch,
              modes=tuple(m for m in args.modes.split(",") if m),
              tiny=args.tiny, emit=emit, device=args.device)
    if args.json:
        print(json.dumps(res), flush=True)
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
