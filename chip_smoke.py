"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the CUDA kernels from ``nerf_qa_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, drives the FR DISTS main
path through ``FrameScorer`` at full VGG16 width (batch 128 of uint8
1080p pairs, resized to 256², bf16, moments kernel), checks that the path
went through the kernel, scores two pairs at full resolution, and times
each kernel against its plain version, its bound and a PyTorch yardstick.
Each phase prints one line; any failure raises and the exit code is not 0.
The last two lines are the kernels' JSON and the device JSON.

It needs a CUDA device and the rest of the repository, and fails without
either. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bytes/s
# and fp32 (non-tensor-core) FLOP/s. The moments kernel does fp32 FMAs.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

BATCH = 128
FRAME_HW = (1080, 1920)
N_BATCHES = 3
TIMED_BATCHES = 10
STAGE_HW = ((256, 256), (256, 256), (128, 128), (64, 64), (32, 32), (16, 16))
STAGE_C = (3, 64, 128, 256, 512, 512)
RTOL, ATOL = 1e-4, 1e-5  # fp32 sums taken in other orders over <= 2M terms
SCORE_ATOL = 1e-4


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check_close(got, want, rtol: float, atol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol·|want| everywhere; return
    the largest absolute error."""
    worst = 0.0
    for name, a, b in zip(got._fields, got, want):
        a = a.double()
        b = b.double()
        err = (a - b).abs()
        bad = err > atol + rtol * b.abs()
        if bool(bad.any()):
            i = int(bad.flatten().nonzero()[0])
            raise AssertionError(
                f"{what} {name}: {a.flatten()[i].item()} vs "
                f"{b.flatten()[i].item()} (rtol {rtol}, atol {atol})")
        worst = max(worst, float(err.max()))
    return worst


def stats_float64_two_pass(fx: torch.Tensor, fy: torch.Tensor):
    from nerf_qa_torch.core.dists import StageStats

    x = fx.double()
    y = fy.double()
    mx, my = x.mean((1, 2)), y.mean((1, 2))
    vx = (x - mx[:, None, None]).square().mean((1, 2))
    vy = (y - my[:, None, None]).square().mean((1, 2))
    cov = ((x - mx[:, None, None]) * (y - my[:, None, None])).mean((1, 2))
    return StageStats(mx, my, vx, vy, cov)


def time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def feature_pair(shape, dtype, gen):
    fx = torch.rand(shape, generator=gen, device="cuda")
    fy = 0.7 * fx + 0.3 * torch.rand(shape, generator=gen, device="cuda")
    return fx.to(dtype), fy.to(dtype)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    # the package comes before any output: alone, the script prints nothing
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_vgg_params,
    )
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.core.dists import pyramid_stats, score_from_stats
    from nerf_qa_torch.eval.video_scorer import FrameScorer
    from nerf_qa_torch.ops.cuda import build, moments
    from nerf_qa_torch.ops.resize import resize_bilinear

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build(force=True)
    build.load_library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=str(build.BUILD_DIR / build.LIB_NAME))

    # 3. kernel vs its plain version on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [((4, h, w, c), dt) for dt in (torch.bfloat16, torch.float32)
              for (h, w), c in zip(STAGE_HW, STAGE_C)]
    shapes += [((1, 17, 33, 3), torch.float32), ((2, 67, 120, 512), torch.float32),
               ((1, 17, 33, 3), torch.bfloat16), ((2, 67, 120, 512), torch.bfloat16),
               ((2, 1080, 1920, 64), torch.bfloat16)]
    max_abs_err = 0.0
    worst = {}
    for shape, dt in shapes:
        fx, fy = feature_pair(shape, dt, gen)
        hw = shape[1] * shape[2]
        got = moments.stats_from_sums(moments.moment_sums(fx, fy), hw)
        want = moments.stats_from_sums(moments.moment_sums_plain(fx, fy), hw)
        key = f"{tuple(shape)} {str(dt).split('.')[-1]}"
        err = check_close(got, want, RTOL, ATOL, f"moments {key} vs plain")
        if shape[1] == 1080:
            err64 = check_close(got, stats_float64_two_pass(fx, fy), RTOL,
                                ATOL, f"moments {key} vs float64 two-pass")
            worst[key + " vs float64"] = err64
        worst[key] = err
        max_abs_err = max(max_abs_err, err)
        del fx, fy
    phase("kernel_vs_plain", rtol=RTOL, atol=ATOL, max_abs_err=worst)

    # 4. the main path at full width: batch-128 uint8 1080p pairs -> 256²
    cfg_k = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
    cfg_e = DISTSConfig(compute_dtype="bfloat16", stats_impl="eager")
    model = resolve_vgg_params(seed=0)
    weights = resolve_dists_weights(cfg_k)
    scorer = FrameScorer(model, weights, cfg=cfg_k)
    eager = FrameScorer(model, weights, cfg=cfg_e)
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = (N_BATCHES * BATCH, *FRAME_HW, 3)
    dist = torch.randint(0, 256, frames, generator=gen, device="cuda",
                         dtype=torch.uint8)
    ref = torch.randint(0, 256, frames, generator=gen, device="cuda",
                        dtype=torch.uint8)
    scorer.score_batch(dist[:BATCH], ref[:BATCH])  # warm-up
    torch.cuda.synchronize()

    moments.launches = 0
    video = scorer.score_video(dist, ref, batch_size=BATCH)
    main_launches = moments.launches
    if main_launches != 6 * N_BATCHES:
        raise AssertionError(f"moments launches {main_launches}, expected "
                             f"{6 * N_BATCHES} (6 per batch)")
    s_k = scorer.score_frames(dist[:BATCH], ref[:BATCH], batch_size=BATCH)
    s_e = eager.score_frames(dist[:BATCH], ref[:BATCH], batch_size=BATCH)
    if not (np.isfinite(s_k).all() and math.isfinite(video)):
        raise AssertionError(f"non-finite scores: video {video}")
    gap = float(abs(s_k - s_e).max())
    if gap > SCORE_ATOL:
        raise AssertionError(f"kernel vs eager stats: score gap {gap}")
    same = scorer.score_frames(dist[:BATCH], dist[:BATCH], batch_size=BATCH)
    if float(abs(same).max()) > SCORE_ATOL:
        raise AssertionError(f"identical pair scores {float(abs(same).max())}")

    # the card against the port's CPU path on a small input (fp32, eager)
    small_d = dist[:4, :90, :120].contiguous().cpu()
    small_r = ref[:4, :90, :120].contiguous().cpu()
    cfg32 = DISTSConfig()
    on_card = FrameScorer(model, weights, cfg32, resize_to=(64, 64)).score_frames(
        small_d, small_r, batch_size=4)
    on_cpu = FrameScorer(resolve_vgg_params(seed=0), weights, cfg32,
                         resize_to=(64, 64), device="cpu").score_frames(
        small_d, small_r, batch_size=4)
    cpu_gap = float(abs(on_card - on_cpu).max())
    if cpu_gap > SCORE_ATOL:
        raise AssertionError(f"card vs CPU fp32 scores differ by {cpu_gap}")

    # frames/s in turns (kernel, eager, eager, kernel), TIMED_BATCHES each
    fps = {"kernel": [], "eager": []}
    for name, sc in (("kernel", scorer), ("eager", eager), ("eager", eager),
                     ("kernel", scorer)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(TIMED_BATCHES):
            j = i % N_BATCHES
            sc.score_batch(dist[j * BATCH:(j + 1) * BATCH],
                           ref[j * BATCH:(j + 1) * BATCH])
        end.record()
        end.synchronize()
        fps[name].append(BATCH * TIMED_BATCHES / (start.elapsed_time(end) / 1e3))
    phase("main_path", batch=BATCH, frame_hw=list(FRAME_HW), batches=N_BATCHES,
          video_score=video, moments_launches=main_launches,
          kernel_vs_eager_max_gap=gap, identical_pair_max=float(abs(same).max()),
          card_vs_cpu_fp32_gap=cpu_gap, frames_per_s_kernel=fps["kernel"],
          frames_per_s_eager=fps["eager"],
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    # where one batch's time goes: the layers of dists.forward on the
    # stream (CUDA events), then the top kernels by device time (profiler)
    d, r = dist[:BATCH], ref[:BATCH]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.no_grad():
        marks[0].record()
        x = resize_bilinear(d, 256, 256, compute_dtype=torch.bfloat16, scale=1 / 255)
        y = resize_bilinear(r, 256, 256, compute_dtype=torch.bfloat16, scale=1 / 255)
        marks[1].record()
        both = scorer.model(torch.cat([x, y]), torch.bfloat16)
        marks[2].record()
        stats = pyramid_stats([f[:BATCH] for f in both], [f[BATCH:] for f in both],
                              cfg_k)
        marks[3].record()
        score_from_stats(stats, scorer.weights, cfg_k)
        marks[4].record()
    marks[4].synchronize()
    layers = dict(zip(("resize_ms", "vgg_ms", "moments_ms", "score_ms"),
                      (a.elapsed_time(b) for a, b in zip(marks, marks[1:]))))
    del x, y, both, stats
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        scorer.score_batch(d, r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    phase("breakdown", batch=BATCH, **layers, profiled_wall_ms=wall_ms,
          device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
          top_kernels=[[name[:160], ms] for name, ms in kernels[:12]])
    del dist, ref, d, r

    # 5. full resolution: stage 1 of the kernel at 2.07M pixels
    full_k = FrameScorer(model, weights, cfg_k, resize_to=None)
    full_e = FrameScorer(model, weights, cfg_e, resize_to=None)
    d2 = torch.randint(0, 256, (2, *FRAME_HW, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    r2 = torch.randint(0, 256, (2, *FRAME_HW, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    moments.launches = 0
    fk = full_k.score_frames(d2, r2, batch_size=2)
    full_launches = moments.launches
    fe = full_e.score_frames(d2, r2, batch_size=2)
    if full_launches != 6 or not np.isfinite(fk).all():
        raise AssertionError(f"full resolution: launches {full_launches}, "
                             f"scores {fk}")
    full_gap = float(abs(fk - fe).max())
    if full_gap > SCORE_ATOL:
        raise AssertionError(f"full resolution kernel vs eager gap {full_gap}")
    phase("full_resolution", frame_hw=list(FRAME_HW), scores=fk.tolist(),
          moments_launches=full_launches, kernel_vs_eager_max_gap=full_gap)
    del d2, r2

    # 6. timings at the main path's stage shapes (batch 128 pairs, bf16)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bound_by = set()
    for (h, w), c in zip(STAGE_HW, STAGE_C):
        shape = (BATCH, h, w, c)
        fx, fy = feature_pair(shape, torch.bfloat16, gen)
        elems = fx.numel()
        n_bytes = 2 * elems * fx.element_size() + BATCH * 5 * c * 4
        ops = 10 * elems  # 5 multiply-adds per element pair
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FP32_FLOPS * 1e3
        bound_by.add("bytes" if t_bytes >= t_ops else "operations")

        def library():
            # yardstick only: no single call gives all five moments
            torch.var_mean(fx, dim=(1, 2), correction=0)
            torch.var_mean(fy, dim=(1, 2), correction=0)
            (fx * fy).mean(dim=(1, 2))

        row = {
            "plain_ms": time_ms(lambda: moments.moment_sums_plain(fx, fy)),
            "ms": time_ms(lambda: moments.moment_sums(fx, fy)),
            "library_ms": time_ms(library),
            "bound_ms": max(t_bytes, t_ops),
        }
        row["ms_again"] = time_ms(lambda: moments.moment_sums(fx, fy))
        row["plain_ms_again"] = time_ms(lambda: moments.moment_sums_plain(fx, fy))
        for k in totals:
            totals[k] += row[k]
        phase("timing", shape=list(shape), dtype="bfloat16", **row)
        del fx, fy

    print(json.dumps({"kernels": [{
        "name": "moments",
        "route": "cuda",
        "source": "nerf_qa_torch/csrc/moments.cu",
        "replaces": "nerf_qa_tpu/ops/pallas/moments.py:41",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": totals["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
