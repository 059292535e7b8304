"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the CUDA kernels from ``nerf_qa_torch/csrc`` (moments, JBU,
ChannelNorm forward and backward, windowed T/S) and holds each against its
plain PyTorch version on the card. It drives four paths at full width and
checks that each went through its kernels:

* FR DISTS through ``FrameScorer`` (batch 128 of uint8 1080p pairs,
  resized to 256², bf16, moments kernel), plus two pairs at full
  resolution;
* NR v8 through ``NRScorer`` / ``NRModel.forward`` (ViT-S/14 depth 12,
  decoder depths 2 / 2, batch 8, seeded random ViT, JBU, decoder and VGG
  weights): JBU, ChannelNorm and moments kernels; scores against the
  all-plain path, the card's fp32 path against the port's CPU path at a
  small depth, frames/s, a per-layer breakdown and the profiler's top
  kernels;
* ADISTS through the score CLI's batch step (``tools.score.adists_batch``)
  at 256² (batch 128 of uint8 1080p pairs, fast bf16 resize, bf16 VGG)
  and at full resolution (two fp32 1080p pairs), windowed T/S kernel:
  scores against the plain T/S version, frames/s, a per-layer breakdown,
  the card's fp32 path against the CPU path, and one run of the score
  CLI (``--metric both``) on PNG pairs;
* NR v8 training through ``NRTrainer`` (the same full width, batch 4 of
  device-generated 256² renders and ground truths, bf16 VGG, both decoder
  dtypes): JBU and ChannelNorm forward and backward kernels; a falling
  loss, one step's losses and decoder gradients against every plain
  version, steps/s and frames/s in turns, a per-layer breakdown, the
  profiler's top kernels, the card's fp32 step against the CPU path at a
  small depth, and the training CLI (``tools.train_nr``) for an epoch, a
  resume and ``score --nr`` of its checkpoint.

It checks and times each kernel at its path's shapes against its plain
version, with its bound and a PyTorch yardstick (the ChannelNorm
backward also with its device time from the profiler); prints the
registers, local memory, shared memory and blocks per SM of the T/S,
JBU and ChannelNorm backward kernels' variants (failing on any spill to
local memory); and holds those three to a bit-for-bit repeat at a path
shape. Each phase prints one line; any failure raises and the exit code
is not 0. The last two lines are the kernels' JSON and the device JSON.

It needs a CUDA device and the rest of the repository, and fails without
either. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
NR_CN_MODULES = 19  # ChannelNorms of the v8 decoder at depths 2 / 2
# ChannelNorm launches per NR batch: every module but the last stage's
# resample, whose output the v7/v8 cascade never computes
NR_CN_PER_BATCH = NR_CN_MODULES - 1
JBU_LEVELS = ((32, 32), (64, 64), (128, 128), (256, 256))
JBU_C, JBU_K = 384, 32
# JBU: fp32 sums of 49 terms and 32-term dots in other orders
JBU_RTOL, JBU_ATOL = 1e-4, 1e-5
CN_CHANNELS = (384, 387, 448, 512, 640, 896)
CN_ROWS = 4099  # a multiple of no tile
# ChannelNorm: fp32 row statistics in other orders; a bf16 output may round
# the other way once (one bf16 ulp: 2**-7 of the value at most)
CN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-2)}
# ADISTS: the 256² path's stages 0-4 (stage 5, 16², is smaller than the
# window) and the 1080p path's six stages
ADISTS_BATCHES = 2  # batches of the counted 256² run
ADISTS_TIMED = 2  # batches per timed turn
FULL_BATCH = 2
# windowed T/S kernel vs its plain version: fp32 window sums in other
# orders, as a share of the d-map's largest value
TSD_RTOL = 1e-4
# per-image ADISTS, T/S kernel vs plain (the same ps and weights on both
# sides, only the d-map's rounding differs)
ADISTS_PLAIN_ATOL = 1e-5
# NR scores, kernels vs the all-plain path on the serving config (both
# sides run the same TF32 convolutions): the kernels' fp32 rounding
# carried through the decoder; measured gaps 2.4e-7 to 3.6e-7
NR_PLAIN_ATOL = 1e-5
# NR training: NRTrainer at the CLI's and the trainer's default batch, on a
# fixed batch at a learning rate that moves the loss within a few steps
TRAIN_BATCH = 4
TRAIN_LR = 3e-4
TRAIN_COUNTED = 3  # steps of the counted run
TRAIN_TIMED = 3  # steps per timed turn
TRAIN_DTYPES = ("bfloat16", "float32")  # decoder: the CLI default, the parity path
# launches per training step: the encoder's 4 JBU levels, and the
# decoder's 18 ChannelNorms forward and 18 backward: every ChannelNorm that
# runs lies on the loss's path (the last stage's resample does not run);
# the losses take eager statistics
TRAIN_LAUNCHES = {"moments": 0, "jbu": 4, "channelnorm": NR_CN_PER_BATCH,
                  "channelnorm_bwd": NR_CN_PER_BATCH, "windowed_tsd": 0}
# the training step's profiler ranges (NRModel.losses, NRTrainer.train_step)
# and the device time launched outside them
TRAIN_LAYERS = ("encode_ms", "decoder_fwd_ms", "losses_ms", "backward_ms",
                "optimizer_ms", "other_ms")
# ChannelNorm backward vs plain: dscale and dbias per channel within this
# share of the sum of their terms' magnitudes (fp32 sums over up to 262k
# rows in another order)
CN_BWD_SUM_RTOL = 1e-5
# one training step's forward and backward, kernels vs every plain version
# from identical weights and generator state: the losses, and each decoder
# gradient relative to its largest value. fp32 (true fp32): the kernels'
# fp32 rounding carried through the step (measured on an H100: loss 0,
# gradients 4.6e-6); bf16: a ChannelNorm or JBU output that rounds to the
# other bf16 neighbour moves what follows by an ulp (loss 8.3e-7,
# gradients 6.6e-3)
TRAIN_PLAIN_LOSS_ATOL = {"float32": 1e-5, "bfloat16": 1e-4}
TRAIN_PLAIN_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
# card fp32 training step vs the CPU path: each decoder gradient relative
# to its largest value (the CPU parity tests' fp32 bar against JAX)
TRAIN_CPU_GRAD_RTOL = 1e-3


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


@contextlib.contextmanager
def recording_bwd_calls(calls: list):
    """Append (rows, C, gelu) of every ChannelNorm backward call inside
    the block to ``calls``."""
    from nerf_qa_torch.ops.cuda import channelnorm

    real = channelnorm.channel_norm_act_bwd

    def record(x, g, scale, bias, *, gelu=False, eps=1e-5):
        calls.append((x.numel() // x.shape[-1], x.shape[-1], bool(gelu)))
        return real(x, g, scale, bias, gelu=gelu, eps=eps)

    channelnorm.channel_norm_act_bwd = record
    try:
        yield calls
    finally:
        channelnorm.channel_norm_act_bwd = real


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
    from nerf_qa_torch.ops.cuda import channelnorm, jbu, moments, windowed_tsd

    moments.launches = jbu.launches = channelnorm.launches = 0
    channelnorm.bwd_launches = windowed_tsd.launches = 0


def launch_counts() -> dict[str, int]:
    from nerf_qa_torch.ops.cuda import channelnorm, jbu, moments, windowed_tsd

    return {"moments": moments.launches, "jbu": jbu.launches,
            "channelnorm": channelnorm.launches,
            "channelnorm_bwd": channelnorm.bwd_launches,
            "windowed_tsd": windowed_tsd.launches}


def kernel_attrs() -> dict[str, dict]:
    """Phase kernel_attrs: registers, local memory, shared memory and
    resident blocks an SM of every variant of the T/S kernel (dtype, copy
    path, tile shape), of the JBU kernel and of the ChannelNorm backward
    (dtype, values a lane, at the variant's widest C), from
    cudaFuncGetAttributes and the occupancy calculator. Fails on local
    memory (spills) or on fewer blocks an SM than a kernel's launch bounds
    or its launch plan take."""
    from nerf_qa_torch.ops.cuda import build, channelnorm, jbu
    from nerf_qa_torch.ops.cuda import windowed_tsd as tsd

    lib = build.load_library()
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        bf = int(dt == torch.bfloat16)
        for vec in (1, 0):
            for s, shp in enumerate(tsd.SHAPES):
                out[tsd_variant(dt, vec, s)] = dict(build.kernel_attrs(
                    lib.nqt_windowed_tsd_attrs, bf, vec, s), plan_blocks_per_sm=shp.blocks_per_sm)
            if not (bf and vec):
                out[f"jbu {name} vec={vec}"] = dict(build.kernel_attrs(
                    lib.nqt_jbu_attrs, bf, vec), plan_blocks_per_sm=jbu.BLOCKS_PER_SM)
        for c in range(32, channelnorm.MAX_CHANNELS + 1, 32):
            out[f"channelnorm_bwd {name} C<={c}"] = build.kernel_attrs(
                lib.nqt_channel_norm_bwd_attrs, bf, c)
    bad = {k: v for k, v in out.items() if v["local_bytes"] > 0 or v["blocks_per_sm"]
           < max(v["min_blocks_per_sm"], v.get("plan_blocks_per_sm", 1))}
    phase("kernel_attrs", variants=out)
    if bad:
        raise AssertionError(f"kernel attributes: spills or occupancy {bad}")
    return out


def tsd_variant(dtype, vec, shape: int) -> str:
    from nerf_qa_torch.ops.cuda import windowed_tsd as tsd

    kind = "narrow" if shape == tsd.NARROW else "wide"
    return f"windowed_tsd {str(dtype).split('.')[-1]} vec={int(vec)} {kind}"


def repeat_check(gen) -> None:
    """Phase repeat: the T/S kernel at (128, 256, 256, 64) bf16, the JBU
    kernel at (8, 256, 256, 384) fp32 and the ChannelNorm backward at
    (262144, 387) bf16 with the GELU, each launched twice on the same
    inputs: the outputs must be equal bit for bit (no atomics, sums in a
    fixed order)."""
    from nerf_qa_torch.ops.cuda import channelnorm, jbu
    from nerf_qa_torch.ops.cuda import windowed_tsd as tsd

    args, inv = tsd_args((BATCH, 256, 256, 64), torch.bfloat16, gen)
    a, b = tsd.windowed_tsd(*args, **inv), tsd.windowed_tsd(*args, **inv)
    tsd_same = bool(torch.equal(a, b))
    del args, inv, a, b
    args = jbu_inputs((NR_BATCH, 256, 256, JBU_C), torch.float32, gen)
    jbu_same = bool(torch.equal(jbu.jbu_filter(*args), jbu.jbu_filter(*args)))
    del args
    args = cn_bwd_inputs(262_144, 387, torch.bfloat16, gen)
    a = channelnorm.channel_norm_act_bwd(*args, gelu=True)
    b = channelnorm.channel_norm_act_bwd(*args, gelu=True)
    cn_same = all(torch.equal(u, v) for u, v in zip(a, b))
    del args, a, b
    phase("repeat", windowed_tsd=[BATCH, 256, 256, 64, "bfloat16", tsd_same],
          jbu=[NR_BATCH, 256, 256, JBU_C, "float32", jbu_same],
          channelnorm_bwd=[262_144, 387, "bfloat16", "gelu", cn_same])
    if not (tsd_same and jbu_same and cn_same):
        raise AssertionError(f"repeat: T/S {tsd_same}, JBU {jbu_same}, "
                             f"ChannelNorm backward {cn_same}")


def check_jbu(gen) -> float:
    """Phase jbu_vs_plain: every NR pyramid level at C = 384, K = 32
    (batch 2) and odd shapes (C = 48, 33, 5: plain loads), fp32 and bf16
    inputs."""
    from nerf_qa_torch.ops.cuda import jbu

    shapes = [(2, h, w, JBU_C) for h, w in JBU_LEVELS] + [
        (1, 17, 33, 48), (1, 16, 16, 33), (2, 23, 37, 5)]
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
    if n_cn != NR_CN_MODULES:
        raise AssertionError(f"decoder has {n_cn} ChannelNorms, expected "
                             f"{NR_CN_MODULES}")
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
            "channelnorm": NR_CN_PER_BATCH * NR_BATCHES, "channelnorm_bwd": 0,
            "windowed_tsd": 0}
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
        del small_counts["windowed_tsd"]  # not on the NR path
        del small_counts["channelnorm_bwd"]  # serving runs no backward
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
    if len(cn_calls) != NR_CN_PER_BATCH:
        raise AssertionError(f"decoder forward ran {len(cn_calls)} ChannelNorms, "
                             f"expected {NR_CN_PER_BATCH}: {cn_calls}")
    del toks, sem, pyramid, dfeats, predicted

    prof = profile_step(lambda: nr_step(scorer, plain, r256, r224, "kernels"))
    phase("nr_path", batch=NR_BATCH, vit_depth=12, decoder_depths=[2, 2],
          launches=counts, launches_per_batch={k: v // NR_BATCHES for k, v in counts.items()},
          scores=scores.tolist(), kernels_vs_plain_max_gap=gap,
          plain_atol=NR_PLAIN_ATOL, card_fp32_vs_cpu_gap=cpu_gap,
          card_fp32_launches=small_counts, frames_per_s=fps,
          layers_ms=layers, **prof,
          peak_mem_gib=peak)
    return nr, counts, cn_calls


def nr_timing(cn_calls, gen, attrs) -> tuple[dict[str, dict], dict[str, float]]:
    """Phase timing rows of the NR kernels at the path's shapes (batch 8,
    fp32), summed per batch: the four JBU levels and the decoder's 18
    ChannelNorm calls. Each call is first held against its plain version
    on the same inputs; returns the rows and each kernel's largest error.
    ``ms`` is one timed run, as for every kernel; a JBU row also gives the
    fastest of three runs (``best_of_3_ms``, its first run included)."""
    from nerf_qa_torch.ops.cuda import build, channelnorm, jbu

    out = {}
    errs = {"jbu": 0.0, "channelnorm": 0.0}
    tot = {"ms": 0.0, "best_of_3_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for h, w in JBU_LEVELS:
        shape = (NR_BATCH, h, w, JBU_C)
        args = jbu_inputs(shape, torch.float32, gen)
        err = check_max(jbu.jbu_filter(*args), jbu.jbu_filter_plain(*args),
                        JBU_RTOL, JBU_ATOL, f"jbu {shape} vs plain")
        errs["jbu"] = max(errs["jbu"], err)
        bound, by = jbu_bound(shape, 4)
        bound_by.add(by)
        # at the small levels the kernel takes about as long as the
        # wrapper's host work, so a run in which the host falls behind
        # times the host: the best of three shows the kernel's own time
        runs = [time_ms(lambda: jbu.jbu_filter(*args)) for _ in range(3)]
        row = {"ms": runs[0], "best_of_3_ms": min(runs),
               "plain_ms": time_ms(lambda: jbu.jbu_filter_plain(*args), iters=5),
               "bound_ms": bound}
        for k in tot:
            tot[k] += row[k]
        plan = jbu._plan(*shape, torch.float32, True, build.sm_count(0))
        a = attrs[f"jbu float32 vec={int(plan.vec)}"]
        phase("timing", kernel="jbu", shape=list(shape), dtype="float32",
              max_abs_err=err, library_ms=None, plan=plan._asdict(),
              registers=a["registers"], blocks_per_sm=a["blocks_per_sm"],
              local_bytes=a["local_bytes"], **row)
        del args
    out["jbu"] = dict(tot, bound_by="bytes" if bound_by == {"bytes"} else "operations",
                      library_ms=None)
    phase("timing", kernel="jbu", per_batch=out["jbu"])

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


def pyramid_hw(h: int, w: int) -> list[tuple[int, int]]:
    """(H, W) of the six pyramid levels of an H×W input (the L2 pool's
    output size is ⌊(H − 1) / 2⌋ + 1)."""
    hw = [(h, w), (h, w)]
    for _ in range(4):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        hw.append((h, w))
    return hw


def tsd_shapes(batch: int, h: int, w: int) -> list[tuple[int, int, int, int]]:
    """The windowed T/S kernel's input shapes on a path: every pyramid
    level that fits the 21×21 window."""
    return [(batch, sh, sw, c) for (sh, sw), c in zip(pyramid_hw(h, w), STAGE_C)
            if sh >= 21 and sw >= 21]


def tsd_args(shape, dtype, gen, ps_value=None, zero_channel=False):
    """Inputs of one T/S call as the ADISTS path gives them: correlated
    non-negative features, ps in [0, 1], normalised weights and the
    inverse spatial L2 norms."""
    n, h, w, c = shape
    fx, fy = feature_pair(shape, dtype, gen)
    if zero_channel:
        fx[..., 0] = 0
    ps = torch.rand((n, h - 20, w - 20), generator=gen, device="cuda")
    if ps_value is not None:
        ps.fill_(ps_value)
    weights = torch.rand((n, c), generator=gen, device="cuda")
    weights /= weights.sum(1, keepdim=True)
    inv = {k: 1 / f.float().square().sum((1, 2)).sqrt().clamp_min(1e-12)
           for k, f in (("inv_x", fx), ("inv_y", fy))}
    return (fx, fy, ps, weights), inv


def tsd_bound(shape, itemsize: int) -> tuple[float, str]:
    """Least time for one T/S call: the pair read once, ps, weights and
    scales read once, the map written once; per channel 4 operations per
    input pixel (xy and ix²x² + iy²y²), 21 taps × 4 moments of
    multiply-adds in the H pass (Hk·W outputs) and in the W pass (Hk·Wk
    outputs), and ~20 operations of T, S and the blend per output, at the
    fp32 rate. Four moments carry the five of the definition: the scaled
    variances enter S only as their sum."""
    n, h, w, c = shape
    hk, wk = h - 20, w - 20
    n_bytes = 2 * n * h * w * c * itemsize + 2 * n * hk * wk * 4 + 3 * n * c * 4
    ops = n * c * (4 * h * w + 168 * hk * w + 188 * hk * wk)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tsd_check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Raise unless |got − want| ≤ TSD_RTOL · max|want|; return the
    largest absolute error."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    if not (torch.isfinite(got).all() and err <= TSD_RTOL * scale):
        raise AssertionError(f"{what}: error {err} vs map scale {scale}")
    return err


def check_tsd(gen, attrs) -> tuple[float, dict[str, dict]]:
    """Phase tsd_vs_plain: the T/S kernel against its plain version at
    every stage shape of the 256² path (batch 128) and of the 1080p path
    (batch 2), in bf16 and fp32, and at edge shapes and values; a timing
    row per path shape in bf16 (the path's dtype). Where the plan takes
    the narrow tile shape, the row also times the wide one on the same
    inputs (``wide_ms``, checked against the plain version too). Returns
    the largest error and each path's summed timing row."""
    from unittest import mock

    from nerf_qa_torch.ops.cuda import build
    from nerf_qa_torch.ops.cuda import windowed_tsd as tsd

    worst = {}
    totals = {}
    for label, shapes in (("256", tsd_shapes(BATCH, 256, 256)),
                          ("1080", tsd_shapes(FULL_BATCH, *FRAME_HW))):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_by = set()
        for dt in (torch.bfloat16, torch.float32):
            for shape in shapes:
                args, inv = tsd_args(shape, dt, gen)
                key = f"{shape} {str(dt).split('.')[-1]}"
                want = tsd.windowed_tsd_plain(*args, **inv)
                worst[key] = tsd_check(tsd.windowed_tsd(*args, **inv), want,
                                       f"windowed_tsd {key} vs plain")
                torch.cuda.synchronize()
                if dt == torch.bfloat16:
                    bound, by = tsd_bound(shape, 2)
                    bound_by.add(by)
                    row = {"ms": time_ms(lambda: tsd.windowed_tsd(*args, **inv), 10),
                           "plain_ms": time_ms(lambda: tsd.windowed_tsd_plain(
                               *args, **inv), 2),
                           "bound_ms": bound}
                    for k in tot:
                        tot[k] += row[k]
                    plan = tsd._plan(*shape, dt, True, build.sm_count(0))
                    if plan.shape == tsd.NARROW:
                        with mock.patch.object(tsd, "_plan", functools.partial(
                                tsd._plan, shape=0)):
                            tsd_check(tsd.windowed_tsd(*args, **inv), want,
                                      f"windowed_tsd {key} wide vs plain")
                            row["wide_ms"] = time_ms(
                                lambda: tsd.windowed_tsd(*args, **inv), 10)
                            row["wide_plan"] = tsd._plan(
                                *shape, dt, True, build.sm_count(0))._asdict()
                    a = attrs[tsd_variant(dt, plan.vec, plan.shape)]
                    phase("timing", kernel="windowed_tsd", path=label,
                          shape=list(shape), dtype="bfloat16",
                          max_abs_err=worst[key], bound_by=by, plan=plan._asdict(),
                          registers=a["registers"], blocks_per_sm=a["blocks_per_sm"],
                          local_bytes=a["local_bytes"], **row)
                del args, inv, want
        totals[label] = dict(tot, bound_by="bytes" if bound_by == {"bytes"}
                             else "operations", library_ms=None)
    for shape, kw in (((1, 21, 21, 3), {}), ((2, 37, 53, 5), {}),
                      ((1, 40, 1920, 8), {}), ((2, 45, 70, 12), {"ps_value": 0.0}),
                      ((2, 45, 70, 12), {"ps_value": 1.0}),
                      ((2, 45, 70, 12), {"zero_channel": True})):
        for dt in (torch.bfloat16, torch.float32):
            args, inv = tsd_args(shape, dt, gen, **kw)
            key = f"{shape} {str(dt).split('.')[-1]} {kw or ''}".strip()
            worst[key] = tsd_check(tsd.windowed_tsd(*args, **inv),
                                   tsd.windowed_tsd_plain(*args, **inv),
                                   f"windowed_tsd {key} vs plain")
            torch.cuda.synchronize()
    phase("tsd_vs_plain", rel_tol=TSD_RTOL, max_abs_err=worst, per_batch=totals)
    return max(worst.values()), totals


def adists_step(model, d_u8, r_u8, cfg) -> torch.Tensor:
    """One ADISTS batch of the 256² serving path: uint8 frames, fast bf16
    resize with the 1/255 scale folded in, then the score CLI's own batch
    step (bf16 VGG, ADISTS, dist as x)."""
    from nerf_qa_torch.ops.resize import resize_bilinear
    from nerf_qa_torch.tools.score import adists_batch

    x = resize_bilinear(d_u8, 256, 256, compute_dtype=torch.bfloat16, scale=1 / 255)
    y = resize_bilinear(r_u8, 256, 256, compute_dtype=torch.bfloat16, scale=1 / 255)
    return adists_batch(model, x, y, cfg)


def adists_layers(model, d_u8, r_u8, cfg) -> tuple[dict[str, float], torch.Tensor]:
    """Where one 256² ADISTS batch's time goes: ``adists.forward``'s steps
    run one by one with CUDA events between them (the same functions, in
    the same order). Returns the ms per layer and the per-image scores."""
    from nerf_qa_torch.config import true_fp32
    from nerf_qa_torch.core import adists
    from nerf_qa_torch.ops.cuda.windowed_tsd import windowed_tsd
    from nerf_qa_torch.ops.resize import resize_bilinear
    from nerf_qa_torch.ops.windowed import fits_window

    layers = dict.fromkeys(("resize_ms", "vgg_ms", "entropy_weights_ms",
                            "gamma_ps_ms", "tsd_kernel_ms", "global_stage_ms"), 0.0)
    spans = []

    def mark(name, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        spans.append((name, a, b))
        return out

    n = d_u8.shape[0]
    with torch.no_grad():
        x, y = mark("resize_ms", lambda: [resize_bilinear(
            f, 256, 256, compute_dtype=torch.bfloat16, scale=1 / 255)
            for f in (d_u8, r_u8)])
        both = mark("vgg_ms", lambda: model(torch.cat([x, y]), torch.bfloat16))
        fx, fy = [f[:n] for f in both], [f[n:] for f in both]
        with true_fp32():
            weight = mark("entropy_weights_ms", lambda: adists.channel_weights(fx))
            offsets = np.cumsum([0] + [f.shape[-1] for f in fx]).tolist()
            d_total = torch.zeros(n, device="cuda")
            ps = torch.ones((n, 256, 256, 1), device="cuda")
            for k in range(5, -1, -1):
                w_k = weight[:, offsets[k]:offsets[k + 1]]
                if fits_window(fx[k].shape[1], fx[k].shape[2], cfg.window_size):
                    def gamma_ps(k=k, ps=ps):
                        g = adists._stage_gamma(fx[k], cfg.window_size,
                                                cfg.block_pixels_threshold,
                                                cfg.channel_block)
                        return (adists._prob_update(g, ps, True),
                                adists._inv_l2_norm(fx[k]), adists._inv_l2_norm(fy[k]))
                    ps, ix, iy = mark("gamma_ps_ms", gamma_ps)
                    d = mark("tsd_kernel_ms", lambda k=k, w_k=w_k, ps=ps, ix=ix, iy=iy:
                             windowed_tsd(fx[k], fy[k], ps, w_k, inv_x=ix, inv_y=iy))
                else:
                    d, ps = mark("global_stage_ms", lambda k=k, w_k=w_k, ps=ps:
                                 adists._global_stage(
                                     fx[k], fy[k], adists._inv_l2_norm(fx[k]),
                                     adists._inv_l2_norm(fy[k]), w_k, ps))
                d_total += d.mean(dim=(1, 2))
    torch.cuda.synchronize()
    for name, a, b in spans:
        layers[name] += a.elapsed_time(b)
    return layers, 1.0 - d_total


def _on_device(e) -> bool:
    """A kernel or copy on the card, not a user annotation's range (such
    as the optimizer's step) that the profiler also lists there."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def profile_step(fn) -> dict:
    """Host wall time, device busy time and idle share, and the top
    kernels by device time of one call under torch.profiler. Busy time is
    the union of the kernels' intervals, so kernels that overlap on
    several streams count once."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3)
                      for e in prof.key_averages() if _on_device(e)),
                     key=lambda kv: -kv[1])
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events() if _on_device(e)):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy_ms = busy_us / 1e3
    out = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "top_kernels": [[name[:160], ms] for name, ms in kernels[:12]]}
    return dict(out, **range_times(prof))


def range_times(prof) -> dict:
    """Per-layer times of a profiled call from the port's own profiler
    ranges (``record_function("nr.*")`` in ``NRModel.losses`` and
    ``NRTrainer.train_step``): each range's host span, and the device time
    of the kernels, copies and sets launched inside it. A kernel belongs
    to the range whose host span holds its launch call, on any thread
    (autograd launches the backward from its own); what no range holds is
    ``other_ms``. Empty when the call ran no such range."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"].split(".", 1)[1] + "_ms")
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("nr.")]
    if not spans:
        return {}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = dict.fromkeys([name for _, _, name in spans] + ["other_ms"], 0.0)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        name = next((n for lo, hi, n in spans if t is not None and lo <= t <= hi),
                    "other_ms")
        device[name] += e["dur"] / 1e3
    host = dict.fromkeys(device, 0.0)
    for lo, hi, name in spans:
        host[name] += (hi - lo) / 1e3
    del host["other_ms"]
    return {"layers_device_ms": device, "layers_host_ms": host}


def adists_path(model, gen) -> dict[str, int]:
    """Phase adists_path: the 256² ADISTS serving path at batch 128,
    counted, checked against the plain T/S version, timed in turns and
    broken down by layer. Returns the launch counts of the counted run."""
    from nerf_qa_torch.config import ADISTSConfig

    cfg = ADISTSConfig(compute_dtype="bfloat16")
    plain = cfg.replace(fused_tsd=False)
    frames = (ADISTS_BATCHES * BATCH, *FRAME_HW, 3)
    dist = torch.randint(0, 256, frames, generator=gen, device="cuda",
                         dtype=torch.uint8)
    ref = torch.randint(0, 256, frames, generator=gen, device="cuda",
                        dtype=torch.uint8)
    batches = [(dist[i * BATCH:(i + 1) * BATCH], ref[i * BATCH:(i + 1) * BATCH])
               for i in range(ADISTS_BATCHES)]
    for c in (cfg, plain):  # warm-up
        adists_step(model, *batches[0], c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    scores = torch.cat([adists_step(model, d, r, cfg) for d, r in batches]).cpu()
    counts = launch_counts()
    want = {"moments": 0, "jbu": 0, "channelnorm": 0, "channelnorm_bwd": 0,
            "windowed_tsd": 5 * ADISTS_BATCHES}
    if counts != want:
        raise AssertionError(f"ADISTS launches {counts}, expected {want}")
    if scores.shape != (ADISTS_BATCHES * BATCH,) or not torch.isfinite(scores).all():
        raise AssertionError(f"ADISTS scores {scores}")
    peak = torch.cuda.max_memory_allocated() / 2**30

    s_plain = adists_step(model, *batches[0], plain).cpu()
    gap = float((scores[:BATCH] - s_plain).abs().max())
    if not gap <= ADISTS_PLAIN_ATOL:
        raise AssertionError(f"ADISTS kernel vs plain T/S: gap {gap}")
    same = adists_step(model, dist[:BATCH], dist[:BATCH], cfg)
    same_max = float(same.abs().max())
    if same_max > SCORE_ATOL:
        raise AssertionError(f"ADISTS identical pair scores {same_max}")

    fps = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        c = cfg if name == "kernel" else plain
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(ADISTS_TIMED):
            adists_step(model, *batches[i % ADISTS_BATCHES], c)
        end.record()
        end.synchronize()
        fps[name].append(BATCH * ADISTS_TIMED / (start.elapsed_time(end) / 1e3))

    layers, replica = adists_layers(model, *batches[0], cfg)
    replica_gap = float((replica.cpu() - scores[:BATCH]).abs().max())
    if replica_gap > 1e-6:
        raise AssertionError(f"layer breakdown's scores differ by {replica_gap}")
    prof = profile_step(lambda: adists_step(model, *batches[0], cfg))
    phase("adists_path", batch=BATCH, frame_hw=list(FRAME_HW),
          batches=ADISTS_BATCHES, launches=counts,
          launches_per_batch=counts["windowed_tsd"] // ADISTS_BATCHES,
          scores_head=scores[:8].tolist(), kernel_vs_plain_max_gap=gap,
          plain_atol=ADISTS_PLAIN_ATOL, identical_pair_max=same_max,
          frames_per_s_kernel=fps["kernel"], frames_per_s_plain=fps["plain"],
          layers_ms=layers, breakdown_vs_forward_gap=replica_gap,
          peak_mem_gib=peak, **prof)
    return counts


def adists_fullres(model, gen) -> None:
    """Phase adists_fullres: two fp32 1080p pairs at full resolution, bf16
    config: kernel against the plain T/S version, launches, frames/s and
    peak memory."""
    from nerf_qa_torch.config import ADISTSConfig
    from nerf_qa_torch.tools.score import adists_batch

    cfg = ADISTSConfig(compute_dtype="bfloat16")
    plain = cfg.replace(fused_tsd=False)
    x = torch.rand((FULL_BATCH, *FRAME_HW, 3), generator=gen, device="cuda")
    y = (0.8 * x + 0.2 * torch.rand(x.shape, generator=gen, device="cuda"))
    adists_batch(model, x, y, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    got = adists_batch(model, x, y, cfg).cpu()
    launches = launch_counts()["windowed_tsd"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = adists_batch(model, x, y, plain).cpu()
    if launches != 6 or not torch.isfinite(got).all():
        raise AssertionError(f"full-resolution ADISTS: launches {launches}, "
                             f"scores {got}")
    gap = float((got - want).abs().max())
    if gap > ADISTS_PLAIN_ATOL:
        raise AssertionError(f"full-resolution ADISTS kernel vs plain gap {gap}")
    ms = {name: time_ms(lambda c=c: adists_batch(model, x, y, c), 2)
          for name, c in (("kernel", cfg), ("plain", plain))}
    phase("adists_fullres", frame_hw=list(FRAME_HW), batch=FULL_BATCH,
          scores=got.tolist(), launches=launches, kernel_vs_plain_max_gap=gap,
          frames_per_s_kernel=FULL_BATCH / (ms["kernel"] / 1e3),
          frames_per_s_plain=FULL_BATCH / (ms["plain"] / 1e3), peak_mem_gib=peak)


def adists_cpu_parity(gen) -> None:
    """Phase adists_cpu_parity: the card's fp32 ADISTS path, the T/S
    kernel on, against the port's CPU path at 64²."""
    from nerf_qa_torch.compat.pretrained import resolve_vgg_params
    from nerf_qa_torch.config import ADISTSConfig
    from nerf_qa_torch.tools.score import adists_batch

    cfg = ADISTSConfig()
    x = torch.rand((4, 64, 64, 3), generator=gen, device="cuda")
    y = (0.8 * x + 0.2 * torch.rand(x.shape, generator=gen, device="cuda"))
    reset_launches()
    on_card = adists_batch(resolve_vgg_params(seed=0).cuda(), x, y, cfg).cpu()
    launches = launch_counts()["windowed_tsd"]
    on_cpu = adists_batch(resolve_vgg_params(seed=0), x.cpu(), y.cpu(), cfg)
    gap = float((on_card - on_cpu).abs().max())
    if launches != 3 or gap > SCORE_ATOL:
        raise AssertionError(f"ADISTS card fp32 vs CPU: gap {gap}, launches "
                             f"{launches}")
    phase("adists_cpu_parity", hw=[64, 64], card_vs_cpu_fp32_gap=gap,
          launches=launches, scores=on_card.tolist())


def window_mean_choice(gen) -> None:
    """Phase window_mean_choice: the two bodies of
    ``ops.windowed.window_mean`` (dense band matmuls, depthwise
    convolutions), both in true fp32, at every γ input of both ADISTS
    paths (a 16-channel block where the path blocks its channels), and
    the one ``window_mean`` takes there."""
    from nerf_qa_torch.config import true_fp32
    from nerf_qa_torch.ops import windowed

    taps = windowed.gaussian_taps(21, 7.0)
    shapes = [("256", s) for s in tsd_shapes(BATCH, 256, 256)]
    shapes += [("1080", (b, h, w, 16 if h * w > 448 * 448 else c))
               for b, h, w, c in tsd_shapes(FULL_BATCH, *FRAME_HW)]
    rows = []
    tot = {p: {"conv_ms": 0.0, "band_ms": 0.0, "chosen_ms": 0.0} for p in ("256", "1080")}
    for path, shape in shapes:
        x = torch.rand(shape, generator=gen, device="cuda")
        with true_fp32():
            band = lambda: windowed.window_mean_band(x, taps)  # noqa: E731
            conv = lambda: windowed.window_mean_conv(x, taps)  # noqa: E731
            err = check_max(conv(), band(), 1e-5, 1e-6,
                            f"window_mean {shape} conv vs band")
            row = {"path": path, "shape": list(shape), "max_abs_err": err,
                   "conv_ms": time_ms(conv, 3), "band_ms": time_ms(band, 3)}
        row["chosen"] = ("band" if shape[1] + shape[2] <= windowed.BAND_MAX_HW
                         else "conv")
        row["chosen_ms"] = row[row["chosen"] + "_ms"]
        for k in tot[path]:
            tot[path][k] += row[k]
        rows.append(row)
        del x
    phase("window_mean_choice", band_max_hw=windowed.BAND_MAX_HW, rows=rows,
          totals=tot)


def score_cli_run() -> dict:
    """Phase score_cli: ``tools.score.main(--metric both --json)`` on three
    PNG pairs written to a temporary directory, on the card."""
    import io

    from PIL import Image

    from nerf_qa_torch.tools import score

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: Path(tmp) / k for k in ("ref", "dist")}
        for d in dirs.values():
            d.mkdir()
        for i in range(3):
            ref = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
            noise = rng.integers(-20, 21, ref.shape)
            dist = np.clip(ref.astype(int) + noise, 0, 255).astype(np.uint8)
            Image.fromarray(ref).save(dirs["ref"] / f"{i:03d}.png")
            Image.fromarray(dist).save(dirs["dist"] / f"{i:03d}.png")
        reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = score.main(["--ref", str(dirs["ref"]), "--dist", str(dirs["dist"]),
                             "--metric", "both", "--json", "--batch-size", "2"])
        counts = launch_counts()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    ok = (rc == 0 and set(result) == {"dists", "adists"}
          and all(result[m]["frames"] == 3 and math.isfinite(result[m]["video_score"])
                  for m in result)
          and counts["moments"] > 0 and counts["windowed_tsd"] > 0)
    if not ok:
        raise AssertionError(f"score CLI: rc {rc}, {result}, launches {counts}")
    phase("score_cli", argv="--metric both --json --batch-size 2", result=result,
          launches=counts)
    return result


def cn_abs_terms(x, g, scale, bias, gelu: bool, eps: float = 1e-5):
    """Per channel, the sums of |dy·x̂| and |dy| that dscale and dbias add
    up: the scale of their rounding."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xh = (xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    dy = g.float()
    if gelu:
        t = xh * scale + bias
        dy = dy * (0.5 * (1 + torch.erf(t * math.sqrt(0.5)))
                   + t * torch.exp(-0.5 * t * t) / math.sqrt(2 * math.pi))
    return (dy * xh).abs().sum(0), dy.abs().sum(0)


def cn_bwd_inputs(rows: int, c: int, dtype, gen):
    x = (1.5 * torch.randn((rows, c), generator=gen, device="cuda") + 0.3).to(dtype)
    g = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
    scale = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return x, g, scale, bias


def cn_bwd_check(x, g, scale, bias, gelu: bool, what: str) -> float:
    """The backward kernel against its plain version on the same inputs:
    dx within CN_TOL, dscale and dbias within CN_BWD_SUM_RTOL of the sums
    of their terms' magnitudes, and a second launch bit for bit equal.
    Returns the largest absolute error."""
    from nerf_qa_torch.ops.cuda import channelnorm

    dx, ds, db = channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=gelu)
    pdx, pds, pdb = channelnorm.channel_norm_act_bwd_plain(x, g, scale, bias, gelu=gelu)
    err = check_max(dx, pdx, *CN_TOL[x.dtype], f"{what} dx")
    for got, want, mag, name in zip((ds, db), (pds, pdb),
                                    cn_abs_terms(x, g, scale, bias, gelu),
                                    ("dscale", "dbias")):
        gap = (got.double() - want.double()).abs()
        if bool((gap > CN_BWD_SUM_RTOL * mag.double()).any()):
            i = int((gap - CN_BWD_SUM_RTOL * mag.double()).argmax())
            raise AssertionError(f"{what} {name}[{i}]: {got[i].item()} vs "
                                 f"{want[i].item()}, terms {mag[i].item()}")
        err = max(err, float(gap.max()))
    again = channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=gelu)
    if not (torch.equal(again[1], ds) and torch.equal(again[2], db)):
        raise AssertionError(f"{what}: dscale / dbias do not repeat bit for bit")
    return err


def cn_bwd_bound(rows: int, c: int, gelu: bool, itemsize: int) -> tuple[float, str]:
    """Least time for one backward call: x and g read once, dx written
    once, scale and bias read and dscale and dbias written once; about 20
    operations per element (statistics, x̂, the two row means, dx, the
    column sums) and 15 more for the GELU's derivative."""
    n_bytes = 3 * rows * c * itemsize + 4 * c * 4
    ops = rows * c * (20 + 15 * gelu)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def device_ms(fn, iters: int = 20, tries: int = 3) -> float | None:
    """Device time per call of fn's kernels, copies and sets under
    torch.profiler (after a warm-up call): the kernels' own time, without
    the host work between launches that CUDA events also see. A session
    can miss some calls' kernels, so each kernel counts at its median
    duration times its launches per call; a session that saw none is run
    again, and after ``tries`` such sessions the time is not measured
    (None)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations = {}
        for e in prof.events():
            if _on_device(e):
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if durations:
            return sum(statistics.median(d) * max(1, round(len(d) / iters))
                       for d in durations.values()) / 1e3
    return None


def add_ms(total: float | None, count: int, t: float | None) -> float | None:
    """total + count · t, not measured (None) if either is not."""
    return None if total is None or t is None else total + count * t


def check_cn_bwd(gen, train_calls: dict[str, list]) -> tuple[float, dict[str, dict]]:
    """Phase cn_bwd_vs_plain: the ChannelNorm backward kernel against its
    plain version on a grid (every decoder width and C = 5, 33 at 4099
    rows; 1, 7 and 262,144 rows at C = 387; GELU on and off, fp32 and
    bf16) and at every (rows, C, GELU) call of one batch-4 training step
    in each decoder dtype, each call also timed against the plain version,
    the bound and the autograd backward of ``F.layer_norm`` + ``F.gelu``
    (a yardstick the port never calls), with its device time from the
    profiler. Returns the largest error and each dtype's per-step totals."""
    from nerf_qa_torch.config import torch_dtype
    from nerf_qa_torch.ops.cuda import build, channelnorm

    grid = [(CN_ROWS, c) for c in CN_CHANNELS + (5, 33)]
    grid += [(rows, 387) for rows in (1, 7, 262_144)]
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for rows, c in grid:
            args = cn_bwd_inputs(rows, c, dt, gen)
            for gelu in (False, True):
                key = f"({rows}, {c}) gelu={gelu} {str(dt).split('.')[-1]}"
                worst[key] = cn_bwd_check(*args, gelu, f"channelnorm bwd {key}")
            del args
    totals = {}
    for name, calls in train_calls.items():
        dt = torch_dtype(name)
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0}
        bound_by = set()
        for (rows, c, gelu), count in sorted({k: calls.count(k) for k in calls}.items()):
            x, g, scale, bias = cn_bwd_inputs(rows, c, dt, gen)
            key = f"({rows}, {c}) gelu={gelu} {name}"
            worst[key] = cn_bwd_check(x, g, scale, bias, gelu, f"channelnorm bwd {key}")
            bound, by = cn_bwd_bound(rows, c, gelu, x.element_size())
            bound_by.add(by)
            xl = x.detach().requires_grad_(True)
            wl = scale.to(dt).requires_grad_(True)
            bl = bias.to(dt).requires_grad_(True)
            y = F.layer_norm(xl, (c,), wl, bl, 1e-5)
            y = F.gelu(y) if gelu else y

            def kernel():
                return channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=gelu)

            row = {"ms": time_ms(kernel), "device_ms": device_ms(kernel),
                   "plain_ms": time_ms(lambda: channelnorm.channel_norm_act_bwd_plain(
                       x, g, scale, bias, gelu=gelu), 5),
                   # yardstick only: the port never calls it
                   "library_ms": time_ms(lambda: torch.autograd.grad(
                       y, (xl, wl, bl), g, retain_graph=True)),
                   "bound_ms": bound}
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                tot[k] += count * row[k]
            tot["device_ms"] = add_ms(tot["device_ms"], count, row["device_ms"])
            plan = channelnorm._bwd_plan(
                rows, c, build.sm_count(x.device), channelnorm._bwd_blocks_per_sm(
                    x.device, dt == torch.bfloat16, c))
            phase("timing", kernel="channelnorm_bwd", rows=rows, c=c, gelu=gelu,
                  calls_per_step=count, dtype=name, max_abs_err=worst[key],
                  bound_by=by, blocks=plan.blocks, **row)
            del x, g, xl, y
        totals[name] = dict(tot, bound_by="bytes" if bound_by == {"bytes"} else "operations")
    phase("cn_bwd_vs_plain", grid=grid, tolerances={
        str(k).split(".")[-1]: v for k, v in CN_TOL.items()},
        sum_rtol=CN_BWD_SUM_RTOL, max_abs_err=worst, per_step=totals)
    return max(worst.values()), totals


def make_trainer(vgg, weights, decoder_dtype: str, vit, jbu):
    """NRTrainer at full width: ViT-S/14 depth 12 and the JBU stack as
    given (seeded random), decoder depths 2 / 2 with dropout 0.2, the
    CLI's bf16 VGG, a fresh decoder and Adam."""
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig, TrainConfig
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.train.nr_train import NRTrainer

    cfg = NRModelConfig(decoder_dtype=decoder_dtype,
                        dists=DISTSConfig(compute_dtype="bfloat16"))
    model = NRModel(vgg, weights, cfg, vit=vit, jbu=jbu)
    trainer = NRTrainer(model, TrainConfig(lr=TRAIN_LR, schedule="constant",
                                           batch_size=TRAIN_BATCH), steps_per_epoch=1)
    trainer.init(seed=0)
    return trainer


def step_grads(trainer, batch, gen_state) -> tuple[dict, dict]:
    """The losses and decoder gradients of one training step's forward and
    backward (no update), the dropout generator at ``gen_state``."""
    model = trainer.model
    trainer.generator.set_state(gen_state)
    model.decoder.train().zero_grad(set_to_none=True)
    with model.train_precision():
        losses = model.losses(*batch, generator=trainer.generator)
        losses["combined"].backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.decoder.named_parameters()}
    model.decoder.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def nr_train_path(vgg, gen) -> tuple[dict[str, dict], dict[str, list]]:
    """Phase nr_train_path: NRTrainer at full width on a fixed batch of 4
    device-generated renders and ground truths, for both decoder dtypes:
    launches per step, a falling finite loss, kernels against the plain
    versions from identical weights and generator state, steps/s and
    frames/s in turns, the profiler's top kernels, idle share and
    per-layer breakdown (from the step's own ranges, ``range_times``) and
    peak memory. Returns each dtype's launch counts and
    ChannelNorm backward calls (rows, C, GELU) of one step."""
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_jbu_params,
        resolve_vit_params,
    )
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.ops.resize import resize_bilinear

    weights = resolve_dists_weights(DISTSConfig(compute_dtype="bfloat16"))
    vit = resolve_vit_params(depth=12, seed=0)
    jbu = resolve_jbu_params(seed=1)
    gt = torch.rand((TRAIN_BATCH, 256, 256, 3), generator=gen, device="cuda")
    render = (gt + 0.05 * torch.randn(gt.shape, generator=gen, device="cuda")).clamp(0, 1)
    batch = (gt, render, resize_bilinear(render, 224, 224))
    all_counts, all_calls = {}, {}
    for dtype in TRAIN_DTYPES:
        trainer = make_trainer(vgg, weights, dtype, vit, jbu)
        model = trainer.model

        def det_loss():
            with torch.no_grad():
                return float(model.losses(*batch)["combined"])

        loss_before = det_loss()
        trainer.train_step(*batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        step_losses = [float(trainer.train_step(*batch)["combined"])
                       for _ in range(TRAIN_COUNTED)]
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: v * TRAIN_COUNTED for k, v in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"NR training ({dtype}) launches {counts}, expected {want}")
        if not all(math.isfinite(v) for v in step_losses):
            raise AssertionError(f"NR training ({dtype}) losses {step_losses}")

        # the kernels against every plain version, one step's forward and
        # backward from identical weights and generator state
        state = trainer.generator.get_state()
        with recording_bwd_calls([]) as calls:
            k_losses, k_grads = step_grads(trainer, batch, state)
        if len(calls) != TRAIN_LAUNCHES["channelnorm_bwd"]:
            raise AssertionError(f"NR training ({dtype}) ChannelNorm backward calls {calls}")
        with plain_versions(model):
            p_losses, p_grads = step_grads(trainer, batch, state)
        loss_gap = max(abs(k_losses[k] - p_losses[k]) for k in k_losses)
        grad_gaps = {n: float((k_grads[n] - p_grads[n]).abs().max())
                     / max(float(p_grads[n].abs().max()), 1e-30) for n in p_grads}
        worst = max(grad_gaps, key=grad_gaps.get)
        if not (loss_gap <= TRAIN_PLAIN_LOSS_ATOL[dtype]
                and grad_gaps[worst] <= TRAIN_PLAIN_GRAD_RTOL[dtype]):
            raise AssertionError(f"NR training ({dtype}) kernels vs plain: loss gap "
                                 f"{loss_gap}, gradient {worst} {grad_gaps[worst]}")
        trainer.generator.set_state(state)

        # steps/s and frames/s in turns
        rates = {"kernels": [], "plain": []}
        for v in ("kernels", "plain", "plain", "kernels"):
            ctx = plain_versions(model) if v == "plain" else contextlib.nullcontext()
            with ctx:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(TRAIN_TIMED):
                    trainer.train_step(*batch)
                end.record()
                end.synchronize()
            rates[v].append(TRAIN_TIMED / (start.elapsed_time(end) / 1e3))

        prof = profile_step(lambda: trainer.train_step(*batch))
        if set(prof.get("layers_device_ms", ())) != set(TRAIN_LAYERS):
            raise AssertionError(f"NR training ({dtype}) profiler ranges {prof}")
        loss_after = det_loss()
        if not (math.isfinite(loss_after) and loss_after < loss_before):
            raise AssertionError(f"NR training ({dtype}) loss {loss_before} -> {loss_after}")
        phase("nr_train_path", decoder_dtype=dtype, vgg_dtype="bfloat16",
              batch=TRAIN_BATCH, vit_depth=12, decoder_depths=[2, 2], dropout=0.2,
              lr=TRAIN_LR, steps=trainer.step, launches=counts,
              launches_per_step={k: v // TRAIN_COUNTED for k, v in counts.items()},
              counted_step_losses=step_losses, det_loss_before=loss_before,
              det_loss_after=loss_after, kernels_vs_plain_loss_gap=loss_gap,
              kernels_vs_plain_worst_grad=[worst, grad_gaps[worst]],
              loss_atol=TRAIN_PLAIN_LOSS_ATOL[dtype],
              grad_rtol=TRAIN_PLAIN_GRAD_RTOL[dtype],
              steps_per_s=rates, frames_per_s={k: [TRAIN_BATCH * r for r in v]
                                               for k, v in rates.items()},
              peak_mem_gib=peak, **prof)
        all_counts[dtype], all_calls[dtype] = counts, calls
        del trainer, model
        torch.cuda.empty_cache()
    return all_counts, all_calls


def nr_train_cpu_parity(gen) -> None:
    """Phase nr_train_cpu_parity: one deterministic fp32 training step's
    forward and backward at a small depth (64² / 56², ViT depth 2, decoder
    depths 1 / 2) on the card, every kernel on, against the port's CPU
    path from the same weights: losses within SCORE_ATOL, decoder
    gradients per tensor within TRAIN_CPU_GRAD_RTOL of their largest
    value."""
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_jbu_params,
        resolve_vgg_params,
        resolve_vit_params,
    )
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.layers import init_lecun_normal_
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.ops.resize import resize_bilinear

    cfg = NRModelConfig(transformer_decoder_depth=1, decoder_dtype="float32",
                        dists=DISTSConfig(compute_dtype="float32"))
    decoder = init_lecun_normal_(NRDecoder(cfg, qkv_bias=True, layer_scale=True),
                                 torch.Generator().manual_seed(3))
    small = NRModel(resolve_vgg_params(seed=0), resolve_dists_weights(cfg.dists), cfg,
                    vit=resolve_vit_params(depth=2, grid_size=4, seed=0),
                    jbu=resolve_jbu_params(seed=1), decoder=decoder,
                    render_size=64, sem_size=56)
    on_cpu = copy.deepcopy(small)
    gt = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    render = (gt + 0.05 * torch.randn(gt.shape, generator=gen, device="cuda")).clamp(0, 1)
    batch = (gt, render, resize_bilinear(render, 56, 56))
    out = {}
    for name, model, args in (("card", small.to("cuda"), batch),
                              ("cpu", on_cpu, [t.cpu() for t in batch])):
        reset_launches()
        model.decoder.train()
        with model.train_precision():
            losses = model.losses(*args)
            losses["combined"].backward()
        out[name] = ({k: float(v) for k, v in losses.items()},
                     {n: torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
                      for n, p in model.decoder.named_parameters()}, launch_counts())
    (kl, kg, counts), (cl, cg, cpu_counts) = out["card"], out["cpu"]
    loss_gap = max(abs(kl[k] - cl[k]) for k in kl)
    grad_gaps = {n: float((kg[n] - cg[n]).abs().max()) / max(float(cg[n].abs().max()), 1e-30)
                 for n in cg}
    worst = max(grad_gaps, key=grad_gaps.get)
    if min(counts[k] for k in ("jbu", "channelnorm", "channelnorm_bwd")) == 0 or any(
            cpu_counts.values()):
        raise AssertionError(f"card launches {counts}, CPU launches {cpu_counts}")
    if loss_gap > SCORE_ATOL or grad_gaps[worst] > TRAIN_CPU_GRAD_RTOL:
        raise AssertionError(f"NR training card vs CPU: loss gap {loss_gap}, "
                             f"gradient {worst} {grad_gaps[worst]}")
    phase("nr_train_cpu_parity", hw=[64, 56], vit_depth=2, decoder_depths=[1, 2],
          losses=kl, loss_gap=loss_gap, worst_grad=[worst, grad_gaps[worst]],
          grad_rtol=TRAIN_CPU_GRAD_RTOL, launches=counts)


def train_cli_run() -> None:
    """Phase train_cli: ``tools.train_nr.main`` on a synthetic NR tree in a
    temporary directory on the card (full width, batch 4, one epoch with
    a validation pass), a resume to a second epoch, then ``score --nr`` of
    the final checkpoint."""
    import io

    from nerf_qa_torch.tools import score, train_nr
    from nerf_qa_torch.tools.make_synthetic_dataset import make_nr_tree

    with tempfile.TemporaryDirectory() as tmp:
        data, run = f"{tmp}/data", f"{tmp}/run"
        csv = make_nr_tree(data, scenes=("chair", "drums", "room"), methods=("nerfacto",),
                           frames=4, hw=(96, 128))
        common = ["--data-dir", data, "--scores-csv", csv, "--output-dir", run,
                  "--batch-size", str(TRAIN_BATCH), "--num-workers", "2",
                  "--holdout-scenes", "room", "--test-every", "1"]
        out = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(out):
            rc1 = train_nr.main(common + ["--epochs", "1", "--checkpoint-every", "1"])
        counts = launch_counts()
        with contextlib.redirect_stdout(out):
            rc2 = train_nr.main(common + ["--epochs", "2", "--resume"])
            rc3 = score.main(["--nr", "--nr-ckpt", f"{run}/ckpt", "--dist",
                              f"{data}/room/nerfacto/color", "--json", "--batch-size", "4"])
        text = out.getvalue()
    result = json.loads(text.strip().splitlines()[-1])
    ok = (rc1 == rc2 == rc3 == 0 and "resumed from epoch 1" in text
          and result["nr"]["frames"] == 4 and math.isfinite(result["nr"]["video_score"])
          and min(counts[k] for k in ("jbu", "channelnorm", "channelnorm_bwd")) > 0)
    if not ok:
        raise AssertionError(f"train CLI: rc {rc1, rc2, rc3}, launches {counts}, "
                             f"output {text[-2000:]}")
    phase("train_cli", argv=" ".join(common[6:] + ["--epochs", "1|2"]), launches=counts,
          epochs=[line for line in text.splitlines() if line.startswith(("epoch", "val"))],
          score_nr=result)


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
    attrs = kernel_attrs()
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
    phase("breakdown", batch=BATCH, **layers,
          **profile_step(lambda: scorer.score_batch(d, r)))
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
    nr_rows, nr_errs = nr_timing(cn_calls, gen, attrs)

    # 8. ADISTS: the T/S kernel at both paths' shapes, the window_mean
    # choice, the 256² path, full resolution, CPU parity and the CLI
    tsd_err, tsd_rows = check_tsd(gen, attrs)
    repeat_check(gen)
    window_mean_choice(gen)
    adists_counts = adists_path(model, gen)
    adists_fullres(model, gen)
    adists_cpu_parity(gen)
    score_cli_run()

    # 9. NR training at full width in both decoder dtypes, then the
    # ChannelNorm backward kernel at its grid and at the path's shapes,
    # the card's fp32 step against the CPU path, and the training CLI
    train_counts, train_calls = nr_train_path(model, gen)
    cn_bwd_err, cn_bwd_rows = check_cn_bwd(gen, train_calls)
    nr_train_cpu_parity(gen)
    train_cli_run()

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
    row = tsd_rows["256"]
    entries.append({
        "name": "windowed_tsd",
        "route": "cuda",
        "source": "nerf_qa_torch/csrc/windowed_tsd.cu",
        "replaces": "nerf_qa_tpu/ops/pallas/windowed_tsd.py:68",
        "launches": adists_counts["windowed_tsd"],
        "max_abs_err": tsd_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    })
    row = cn_bwd_rows["bfloat16"]  # the CLI's default decoder dtype
    entries.append({
        "name": "channelnorm_bwd",
        "route": "cuda",
        "source": "nerf_qa_torch/csrc/channelnorm.cu",
        "replaces": "nerf_qa_tpu/ops/pallas/channelnorm.py:90",
        "launches": sum(c["channelnorm_bwd"] for c in train_counts.values()),
        "max_abs_err": cn_bwd_err,
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
