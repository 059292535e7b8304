"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the CUDA kernels from ``nerf_qa_torch/csrc`` (moments, JBU,
ChannelNorm) and holds each against its plain PyTorch version on the
card. It drives two paths at full width and checks that each went through
its kernels:

* FR DISTS through ``FrameScorer`` (batch 128 of uint8 1080p pairs,
  resized to 256², bf16, moments kernel), plus two pairs at full
  resolution;
* NR v8 through ``NRScorer`` / ``NRModel.forward`` (ViT-S/14 depth 12,
  decoder depths 2 / 2, batch 8, seeded random ViT, JBU, decoder and VGG
  weights): JBU, ChannelNorm and moments kernels; scores against the
  all-plain path, the card's fp32 path against the port's CPU path at a
  small depth, frames/s, a per-layer breakdown and the profiler's top
  kernels.

It checks and times each kernel at its path's shapes against its plain
version, with its bound and a PyTorch yardstick. Each phase prints one line; any failure
raises and the exit code is not 0. The last two lines are the kernels'
JSON and the device JSON.

It needs a CUDA device and the rest of the repository, and fails without
either. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

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

NR_BATCH = 8
NR_BATCHES = 2  # batches of the counted NR run
NR_TIMED = 5  # batches per timed turn
NR_CN_PER_BATCH = 19  # ChannelNorms of the v8 decoder at depths 2 / 2
JBU_LEVELS = ((32, 32), (64, 64), (128, 128), (256, 256))
JBU_C, JBU_K = 384, 32
# JBU: fp32 sums of 49 terms and 32-term dots in other orders
JBU_RTOL, JBU_ATOL = 1e-4, 1e-5
CN_CHANNELS = (384, 387, 448, 512, 640, 896)
CN_ROWS = 4099  # a multiple of no tile
# ChannelNorm: fp32 row statistics in other orders; a bf16 output may round
# the other way once (one bf16 ulp: 2**-7 of the value at most)
CN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-2)}
# NR scores, kernels vs the all-plain path on the serving config (both
# sides run the same TF32 convolutions): the kernels' fp32 rounding
# carried through the decoder; measured gaps 2.4e-7 to 3.6e-7
NR_PLAIN_ATOL = 1e-5


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check_max(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
              what: str) -> float:
    """Raise unless |got - want| <= atol + rtol·|want| everywhere; return
    the largest absolute error."""
    a = got.double()
    b = want.double()
    err = (a - b).abs()
    bad = err > atol + rtol * b.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{what}: {a.flatten()[i].item()} vs "
                             f"{b.flatten()[i].item()} (rtol {rtol}, atol {atol})")
    return float(err.max()) if err.numel() else 0.0


def check_close(got, want, rtol: float, atol: float, what: str) -> float:
    """check_max over the fields of two named tuples of tensors."""
    return max(check_max(a, b, rtol, atol, f"{what} {name}")
               for name, a, b in zip(got._fields, got, want))


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


def jbu_inputs(shape, dtype, gen):
    n, h, w, c = shape
    hr = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    proj = (0.3 * torch.randn((n, h, w, JBU_K), generator=gen,
                              device="cuda")).to(dtype)
    offs = torch.linspace(-1, 1, 7, device="cuda")
    spatial = torch.exp(-(offs[:, None] ** 2 + offs[None, :] ** 2).reshape(-1)
                        / (2 * 0.9**2))
    return hr, proj, spatial, torch.tensor(1.3, device="cuda")


def jbu_bound(shape, itemsize: int) -> tuple[float, str]:
    """Least time for one JBU call: each input read once, the fp32 output
    written once; 49·(2K + 2C) multiply-adds plus ~4·49 softmax and
    normalisation operations per pixel at the fp32 rate."""
    n, h, w, c = shape
    px = n * h * w
    n_bytes = px * (c + JBU_K) * itemsize + px * c * 4 + 50 * 4
    ops = px * 49 * (2 * JBU_K + 2 * c + 4)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cn_bound(rows: int, c: int, gelu: bool, itemsize: int) -> tuple[float, str]:
    """Least time for one ChannelNorm call: the rows read and written once,
    scale and bias read once; about 7 operations per element (mean,
    centred variance, normalise, affine) and 5 more for the GELU."""
    n_bytes = 2 * rows * c * itemsize + 2 * c * 4
    ops = rows * c * (7 + 5 * gelu)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@contextlib.contextmanager
def plain_versions(model):
    """Send the model's JBU stages and ChannelNorms to their plain versions
    inside the block."""
    from nerf_qa_torch.models.nr.featup import JBU
    from nerf_qa_torch.models.nr.layers import ChannelNorm

    mods = [m for m in model.modules() if isinstance(m, (JBU, ChannelNorm))]
    for m in mods:
        m.fused = False
    try:
        yield
    finally:
        for m in mods:
            m.fused = True


def channelnorm_calls(model, feats) -> list[tuple[int, int, bool]]:
    """(rows, C, gelu) of every ChannelNorm call of one decoder forward,
    read with forward hooks."""
    from nerf_qa_torch.models.nr.layers import ChannelNorm

    calls = []

    def hook(module, args, kwargs, out):
        x = args[0]
        calls.append((x.numel() // x.shape[1], x.shape[1],
                      bool(kwargs.get("gelu", False))))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.decoder.modules() if isinstance(m, ChannelNorm)]
    try:
        with torch.no_grad():
            model.apply_decoder(feats)
    finally:
        for h in handles:
            h.remove()
    return calls


def reset_launches() -> None:
    from nerf_qa_torch.ops.cuda import channelnorm, jbu, moments

    moments.launches = jbu.launches = channelnorm.launches = 0


def launch_counts() -> dict[str, int]:
    from nerf_qa_torch.ops.cuda import channelnorm, jbu, moments

    return {"moments": moments.launches, "jbu": jbu.launches,
            "channelnorm": channelnorm.launches}


def check_jbu(gen) -> float:
    """Phase jbu_vs_plain: every NR pyramid level at C = 384, K = 32
    (batch 2) and an odd shape, fp32 and bf16 inputs."""
    from nerf_qa_torch.ops.cuda import jbu

    shapes = [(2, h, w, JBU_C) for h, w in JBU_LEVELS] + [(1, 17, 33, 48)]
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            args = jbu_inputs(shape, dt, gen)
            key = f"{shape} {str(dt).split('.')[-1]}"
            worst[key] = check_max(jbu.jbu_filter(*args), jbu.jbu_filter_plain(*args),
                                   JBU_RTOL, JBU_ATOL, f"jbu {key} vs plain")
            del args
    phase("jbu_vs_plain", rtol=JBU_RTOL, atol=JBU_ATOL, max_abs_err=worst)
    return max(worst.values())


def check_channelnorm(gen) -> float:
    """Phase channelnorm_vs_plain: every decoder width, GELU on and off,
    fp32 and bf16, a row count that is a multiple of no tile."""
    from nerf_qa_torch.ops.cuda import channelnorm

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        rtol, atol = CN_TOL[dt]
        for c in CN_CHANNELS:
            x = (1.5 * torch.randn((CN_ROWS, c), generator=gen, device="cuda")
                 + 0.3).to(dt)
            scale = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
            bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
            for gelu in (False, True):
                key = f"({CN_ROWS}, {c}) gelu={gelu} {str(dt).split('.')[-1]}"
                got = channelnorm.channel_norm_act(x, scale, bias, gelu=gelu)
                want = channelnorm.channel_norm_act_plain(x, scale, bias, gelu=gelu)
                worst[key] = check_max(got, want, rtol, atol,
                                       f"channelnorm {key} vs plain")
    phase("channelnorm_vs_plain", rows=CN_ROWS, tolerances={
        str(k).split(".")[-1]: v for k, v in CN_TOL.items()}, max_abs_err=worst)
    return max(worst.values())


def nr_step(scorer, plain_model, r256, r224, variant: str) -> torch.Tensor:
    """One NR batch on the card: 'kernels' (the default path: JBU,
    ChannelNorm and moments kernels) or 'plain' (every plain version)."""
    if variant == "plain":
        with plain_versions(plain_model), torch.no_grad():
            return plain_model(r256, r224)
    return scorer.step_batch(r256, r224)


def nr_path(vgg, gen):
    """Phase nr_path: the NR v8 serving path at full width, counted,
    checked and timed. Returns the model and the kernels' launch counts of
    the counted run."""
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_jbu_params,
        resolve_vgg_params,
        resolve_vit_params,
    )
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig
    from nerf_qa_torch.models.nr.layers import ChannelNorm
    from nerf_qa_torch.models.nr.model import EncoderFeats, NRModel
    from nerf_qa_torch.ops.resize import resize_bilinear
    from nerf_qa_torch.tools.score import NRScorer

    cfg = NRModelConfig(dists=DISTSConfig(compute_dtype="bfloat16",
                                          stats_impl="kernel"))
    weights = resolve_dists_weights(cfg.dists)
    nr = NRModel(vgg, weights, cfg, vit=resolve_vit_params(depth=12, seed=0),
                 jbu=resolve_jbu_params(seed=1), seed=2)
    scorer = NRScorer(nr, batch_size=NR_BATCH)
    n_cn = sum(isinstance(m, ChannelNorm) for m in nr.decoder.modules())
    if n_cn != NR_CN_PER_BATCH:
        raise AssertionError(f"decoder has {n_cn} ChannelNorms, expected "
                             f"{NR_CN_PER_BATCH}")
    plain = NRModel(vgg, weights, cfg.replace(dists=cfg.dists.replace(
        stats_impl="eager")), vit=nr.vit, jbu=nr.jbu, decoder=nr.decoder).to("cuda")

    r256 = torch.rand((NR_BATCH, 256, 256, 3), generator=gen, device="cuda")
    r224 = resize_bilinear(r256, 224, 224)
    for variant in ("kernels", "plain"):  # warm-up
        nr_step(scorer, plain, r256, r224, variant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the counted run: NR_BATCHES batches of host frames through the entry
    # point (host resize, batched_map), every kernel of the path on
    frames = torch.rand((NR_BATCHES * NR_BATCH, 270, 480, 3), generator=gen,
                        device="cuda").cpu().numpy()
    reset_launches()
    scores = scorer.score_frames(frames)
    counts = launch_counts()
    want = {"jbu": 4 * NR_BATCHES, "moments": 6 * NR_BATCHES,
            "channelnorm": NR_CN_PER_BATCH * NR_BATCHES}
    if counts != want:
        raise AssertionError(f"NR launches {counts}, expected {want}")
    if scores.shape != (NR_BATCHES * NR_BATCH,) or not np.isfinite(scores).all():
        raise AssertionError(f"NR scores {scores}")

    # the kernels against the all-plain path on one device batch
    s = {v: nr_step(scorer, plain, r256, r224, v).float().cpu()
         for v in ("kernels", "plain")}
    gap = float((s["kernels"] - s["plain"]).abs().max())
    if not all(torch.isfinite(t).all() for t in s.values()) or not gap <= NR_PLAIN_ATOL:
        raise AssertionError(f"NR kernels vs plain: gap {gap} (atol "
                             f"{NR_PLAIN_ATOL}), scores {s}")

    # the card in true fp32, every kernel on, against the port's CPU path
    cfg32 = NRModelConfig(dists=DISTSConfig(compute_dtype="float32",
                                            stats_impl="kernel"))
    small = NRModel(resolve_vgg_params(seed=0), weights, cfg32,
                    vit=resolve_vit_params(depth=2, grid_size=4, seed=0),
                    jbu=resolve_jbu_params(seed=1), seed=2, render_size=64,
                    sem_size=56)
    small_cpu = copy.deepcopy(small)
    x64 = r256[:4, :64, :64].contiguous()
    x56 = resize_bilinear(x64, 56, 56)
    with torch.no_grad():
        reset_launches()
        on_card = small.to("cuda")(x64, x56).cpu()
        small_counts = launch_counts()
        on_cpu = small_cpu(x64.cpu(), x56.cpu())
    if min(small_counts.values()) == 0:
        raise AssertionError(f"fp32 card path skipped a kernel: {small_counts}")
    cpu_gap = float((on_card - on_cpu).abs().max())
    if cpu_gap > SCORE_ATOL:
        raise AssertionError(f"NR card fp32 vs CPU: gap {cpu_gap}")
    del small, small_cpu

    # frames/s in turns, NR_TIMED batches each
    fps = {"kernels": [], "plain": []}
    for v in ("kernels", "plain", "plain", "kernels"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(NR_TIMED):
            nr_step(scorer, plain, r256, r224, v)
        end.record()
        end.synchronize()
        fps[v].append(NR_BATCH * NR_TIMED / (start.elapsed_time(end) / 1e3))
    peak = torch.cuda.max_memory_allocated() / 2**30

    # where one batch's time goes (CUDA events on the stream)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.no_grad():
        marks[0].record()
        toks = nr.vit(r224)
        sem = toks["x_norm_patchtokens"].reshape(NR_BATCH, 16, 16, -1)
        marks[1].record()
        pyramid = nr.jbu(sem, r224)
        marks[2].record()
        dfeats = nr.vgg(r256, torch.bfloat16)
        marks[3].record()
        feats = EncoderFeats(dfeats, sem, pyramid)
        predicted, _ = nr.apply_decoder(feats)
        marks[4].record()
        nr._compose_score(feats, predicted)
        marks[5].record()
    marks[5].synchronize()
    layers = dict(zip(
        ("vit_ms", "jbu_pyramid_ms", "vgg_ms", "decoder_ms", "score_ms"),
        (a.elapsed_time(b) for a, b in zip(marks, marks[1:]))))
    cn_calls = channelnorm_calls(nr, feats)
    del toks, sem, pyramid, dfeats, predicted

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        nr_step(scorer, plain, r256, r224, "kernels")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    phase("nr_path", batch=NR_BATCH, vit_depth=12, decoder_depths=[2, 2],
          launches=counts, launches_per_batch={k: v // NR_BATCHES for k, v in counts.items()},
          scores=scores.tolist(), kernels_vs_plain_max_gap=gap,
          plain_atol=NR_PLAIN_ATOL, card_fp32_vs_cpu_gap=cpu_gap,
          card_fp32_launches=small_counts, frames_per_s=fps,
          layers_ms=layers, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
          device_idle_share=1 - busy_ms / wall_ms,
          top_kernels=[[name[:160], ms] for name, ms in kernels[:12]],
          peak_mem_gib=peak)
    return nr, counts, cn_calls


def nr_timing(cn_calls, gen) -> tuple[dict[str, dict], dict[str, float]]:
    """Phase timing rows of the NR kernels at the path's shapes (batch 8,
    fp32), summed per batch: the four JBU levels and the decoder's
    ChannelNorm calls. Each call is first held against its plain version
    on the same inputs; returns the rows and each kernel's largest error."""
    from nerf_qa_torch.ops.cuda import channelnorm, jbu

    out = {}
    errs = {"jbu": 0.0, "channelnorm": 0.0}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for h, w in JBU_LEVELS:
        shape = (NR_BATCH, h, w, JBU_C)
        args = jbu_inputs(shape, torch.float32, gen)
        err = check_max(jbu.jbu_filter(*args), jbu.jbu_filter_plain(*args),
                        JBU_RTOL, JBU_ATOL, f"jbu {shape} vs plain")
        errs["jbu"] = max(errs["jbu"], err)
        bound, by = jbu_bound(shape, 4)
        bound_by.add(by)
        row = {"ms": time_ms(lambda: jbu.jbu_filter(*args)),
               "plain_ms": time_ms(lambda: jbu.jbu_filter_plain(*args), iters=5),
               "bound_ms": bound}
        row["ms_again"] = time_ms(lambda: jbu.jbu_filter(*args))
        for k in tot:
            tot[k] += row[k]
        phase("timing", kernel="jbu", shape=list(shape), dtype="float32",
              max_abs_err=err, library_ms=None, **row)
        del args
    out["jbu"] = dict(tot, bound_by="bytes" if bound_by == {"bytes"} else "operations",
                      library_ms=None)

    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bound_by = set()
    rtol, atol = CN_TOL[torch.float32]
    for (rows, c, gelu), count in sorted(
            {k: cn_calls.count(k) for k in cn_calls}.items()):
        x = torch.randn((rows, c), generator=gen, device="cuda")
        scale = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
        err = check_max(channelnorm.channel_norm_act(x, scale, bias, gelu=gelu),
                        channelnorm.channel_norm_act_plain(x, scale, bias, gelu=gelu),
                        rtol, atol, f"channelnorm ({rows}, {c}) gelu={gelu} vs plain")
        errs["channelnorm"] = max(errs["channelnorm"], err)
        bound, by = cn_bound(rows, c, gelu, 4)
        bound_by.add(by)

        def library():
            # yardstick only: the port never calls it
            y = F.layer_norm(x, (c,), scale, bias, 1e-5)
            return F.gelu(y) if gelu else y

        row = {"ms": time_ms(lambda: channelnorm.channel_norm_act(
                   x, scale, bias, gelu=gelu)),
               "plain_ms": time_ms(lambda: channelnorm.channel_norm_act_plain(
                   x, scale, bias, gelu=gelu)),
               "library_ms": time_ms(library), "bound_ms": bound}
        for k in tot:
            tot[k] += count * row[k]
        phase("timing", kernel="channelnorm", rows=rows, c=c, gelu=gelu,
              calls_per_batch=count, dtype="float32", max_abs_err=err, **row)
        del x
    out["channelnorm"] = dict(tot, bound_by="bytes" if bound_by == {"bytes"}
                              else "operations")
    return out, errs


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
    jbu_err = check_jbu(gen)
    cn_err = check_channelnorm(gen)

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

    reset_launches()
    video = scorer.score_video(dist, ref, batch_size=BATCH)
    fr_counts = launch_counts()
    main_launches = fr_counts["moments"]
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
          video_score=video, launches=fr_counts,
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

    # 7. the NR v8 path at full width, then its kernels' timings
    nr, nr_counts, cn_calls = nr_path(model, gen)
    del nr
    nr_rows, nr_errs = nr_timing(cn_calls, gen)

    entries = [{
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
    }]
    for name, replaces, err in (
            ("jbu", "nerf_qa_tpu/ops/pallas/jbu.py:34", jbu_err),
            ("channelnorm", "nerf_qa_tpu/ops/pallas/channelnorm.py:78", cn_err)):
        row = nr_rows[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"nerf_qa_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": nr_counts[name],
            "max_abs_err": max(err, nr_errs[name]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
