"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the CUDA kernels from ``nerf_qa_torch/csrc`` (moments, JBU,
ChannelNorm forward and backward, windowed T/S) and holds each against its
plain PyTorch version on the card. It drives every path at full width and
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
  resume and ``score --nr`` of its checkpoint;
* the rest of NR training (the same full width, batch 4): the score-map
  objective in both decoder dtypes, against every plain version and the
  CPU path, with 4 JBU, 18 + 18 ChannelNorm and 0 T/S launches a step
  (``nr_scoremap_train``); remat against the plain step, with both peak
  memories (``nr_remat``); v1-v6, a scoring batch and a training step
  each, against eager statistics and the CPU path (``nr_versions``); the
  ViT-token cache (``nr_feature_cache``); ``prep_nr --score-maps`` with
  its T/S kernel against the plain maps, ``train_nr`` with each new flag
  and ``score --nr`` (``nr_cli_full``); and the two forms of the
  decoders' transposed conv timed (``subpixel_choice``);
* FR training through ``FRTrainer`` (VGG16 at full width, batch 32 of 256²
  pairs made on the card, the logistic head, both pyramid dtypes): the
  moments kernel, 6 launches per step, cache batch and eval batch; a
  falling loss, one step's loss and head and α/β gradients against the
  eager statistics, the cached step against the image step, the card's
  fp32 step against the CPU path, frames/s in turns, cache-build frames/s,
  cached-epoch ms per step, the step's per-range breakdown and idle share;
  the FR tools (``run_fr`` with and without the stats cache, ``prep_fr``
  with the square and full-size policies, whose ADISTS column takes the
  windowed T/S kernel, ``reeval`` of the trained checkpoint); and the FR
  quality certificate (``quality_demo --kind fr``, seeds 0-2, held to
  cv_plcc >= 0.90, cv_srcc >= 0.80, cv_ktcc >= 0.60);
* the data feed and the scoring service: the native decoder built with
  g++ (or the reason it cannot be, and then the PIL route), held to PIL
  where it builds, with the host's 1080p JPEG -> 256² decode rate by
  thread count (``native_decoder``); 1080p MJPEG mp4 pairs through
  ``score.main`` against the same JPEGs as frame directories
  (``mp4_path``, where the decoder builds); the service
  (``tools.serve.ScoringService`` behind its HTTP server, batch 32, bf16,
  NR v8 at full width from a seeded ``.pth``) under 8 clients with four
  12-frame 1080p FR and NR requests each in flight, every stepped batch
  replayed through the scorers called directly and every response found
  among their outputs, the moments, T/S, JBU and ChannelNorm
  kernels' launches against the steps, coalescing, latency, the idle
  share and the host decode share (``serve_path``), a ``--full-size``
  1080p request cold and warm (``serve_full_size``), the service's CLI
  in a subprocess on its default device (``serve_cli``), and the feed
  benchmark's sustained rates beside the device's (``feed``);
* the comparison and readiness tools: the eleven classical IQA metrics
  (``eval/iqa.py``, true fp32) at prep_fr's sizes (batch 8 at 256², two
  1080p pairs), identities, ms a batch in turns and frames/s, the card
  against the CPU path (``iqa_metrics``, ``iqa_cpu_parity``);
  ``prep_fr --iqa`` with all eleven columns, DISTS and ADISTS on a
  synthetic tree, 6 moments and 5 T/S launches a batch, wall time a video
  with and without the columns (``prep_fr_iqa``); ``plot_results`` on its
  CSV (``results_tables``); ``golden_check`` card against CPU and its CLI
  (``golden_check``); a 64-image retrieval index and ``pseudo_fr_score``
  of shifted pairs, its fp32 parts card against CPU (``retrieval``);
  ``verify_assets`` over seeded checkpoints in the reference layouts, 4
  JBU and 18 ChannelNorm launches an NR v8 forward (``verify_assets``);
  and a three-trial bayes sweep of the bundled FR config through run_fr
  (``sweep``);
* many devices, each mesh made of copies of the one card ([cuda:0] × n
  stands in for n GPUs): ``FrameScorer`` over a data mesh of two at batch
  128 against the unsharded scorer, bf16 within the batch-position bound
  and fp32 within 2e-5 (``parallel_scorer``); spatial DISTS and ADISTS of
  two 1088 × 1920 pairs with H split 2 and 4 ways against the
  single-device paths, each slab's moment sums and each block's T/S map
  held to their plain versions (``spatial_dists``, ``spatial_adists``);
  ``FRTrainer`` and ``NRTrainer`` (v8 both dtypes, v1) over the data mesh
  against their unsharded steps (``parallel_train``); the scorer, spatial
  DISTS and NRTrainer over [cuda:0, cpu], whose shards run on copies of
  their own (``mixed_mesh``); a world of one over
  NCCL and two processes sharing the card over gloo taking one
  data-parallel FR step (``multiprocess``); the service's
  --data-parallel and --spatial 2 against the direct scorers
  (``serve_parallel``); and ``bench_op`` beside a bare event loop.

It checks and times each kernel at its paths' shapes against its plain
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
import os
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
# the score-map step launches what the gt step does: its ADISTS takes the
# plain T/S version under autograd (the kernel has no backward)
SCOREMAP_LAUNCHES = dict(TRAIN_LAUNCHES)
# the score-map step's learning rate: the CLI's default. At 3e-4 its
# score-map loss first rises for a few steps from the random init
# (measured on the CPU at 128², full decoder width), at 1e-4 it falls
SCOREMAP_LR = 1e-4
# a remat step recomputes each RefineUp stage in the backward: every
# ChannelNorm forward of the cascade again (17: three a stage, two in the
# last, whose resample does not run; trans2sem's is outside the
# checkpoints), the backward unchanged
NR_CN_RECOMPUTED = 5 * 3 + 2
REMAT_LAUNCHES = dict(TRAIN_LAUNCHES, channelnorm=NR_CN_PER_BATCH + NR_CN_RECOMPUTED)
# remat against the plain step on the card: the same arithmetic, but
# cuDNN's backward kernels may sum in another order between calls
# (losses and gradients relative to the largest)
REMAT_RTOL = 1e-6
# v1-v6: no JBU, no ChannelNorm; a scoring batch takes the moments kernel
# at its six stages (v4, whose score is the regression head's alone, none),
# a training step eager statistics
VERSION_SCORE_LAUNCHES = {"moments": 6, "jbu": 0, "channelnorm": 0,
                          "channelnorm_bwd": 0, "windowed_tsd": 0}
VERSION_TRAIN_LAUNCHES = dict.fromkeys(VERSION_SCORE_LAUNCHES, 0)
# v1-v6 card vs CPU, one fp32 step at 64² on inputs from a seed of their
# own: the BatchNorm running averages after it relative to their largest
# value (fp32 means over 8,192-32,768 values in another order); the decoder
# gradient per tensor relative to its largest value (``step_gaps``) and as
# a whole (L2 relative to its norm). The BatchNorm generations' gradients
# carry the card's other summation orders far (flax's E[x²] − E[x]² batch
# variance cancels). Each gradient bar sits between what the card reads
# and what the fault ``unbiased_batchnorm`` gives on the CPU, both printed
# by ``nr_versions_cpu_parity`` every run (on an NVIDIA H100 80GB HBM3 at
# 700 W: per tensor at most 3.4e-2 against at least 0.146, in L2 at most
# 1.22e-2 against at least 5.0e-2)
VERSION_SEED = 5
VERSION_STATS_RTOL = 1e-5
VERSION_GRAD_RTOL = 7e-2
VERSION_GRAD_L2 = 2.5e-2
# the cached-token step against the uncached one: fp16 tokens (the JAX
# package's bar, tests/test_feature_cache.py:79)
CACHE_ATOL = 2e-3
# prep_nr --score-maps: the T/S kernel at stages 0-4 of a 256² frame
# (stage 5, 16², is smaller than the window); the float maps kernel vs
# plain before the -log10 encoding
PREP_TSD_PER_FRAME = 5
SCOREMAP_ATOL = 1e-5
# FR training: FRTrainer at the FR device batch (DEVICE_BATCH_SIZE_FR = 32
# pairs, one pyramid batch of 64 images at 256²) with run_fr's defaults (the
# logistic head, lr 1e-4, the exponential schedule with its one-epoch
# linear warm-up) at FR_STEPS_PER_EPOCH steps an epoch (3,200 pairs). At a
# constant 1e-4 from the first step, Adam moves each of the 2,950 α/β
# (~3e-4 each) by about 1e-4 at once and the loss of a fixed batch jumps
# and oscillates; the warm-up is what the CLI runs
FR_BATCH = 32
FR_LR = 1e-4
FR_STEPS_PER_EPOCH = 100
FR_COUNTED = 3  # steps of the counted run
FR_TIMED = 5  # steps per timed turn
FR_CACHE_BATCHES = 4  # batches of the timed cache build and cached epoch
FR_DTYPES = ("float32", "bfloat16")  # the CLI default, then the fast pyramid
# launches per FR step, cache batch and eval batch: the moments kernel once
# a stage on the dist and ref halves of one pyramid batch
FR_LAUNCHES = {"moments": 6, "jbu": 0, "channelnorm": 0, "channelnorm_bwd": 0,
               "windowed_tsd": 0}
# the FR step's profiler ranges (models/fr.pair_stats, FRTrainer)
FR_LAYERS = ("pyramid_ms", "stats_ms", "head_loss_ms", "backward_ms",
             "optimizer_ms", "other_ms")
# one FR step with the moments kernel against the eager statistics from
# identical params: both routes take the same pyramid features and differ
# only in how the moments are summed, so the bars sit well under NR's
# TRAIN_PLAIN_* (measured on an H100: loss 6.0e-8 fp32, 4.0e-7 bf16; each
# gradient 1.1e-5 to 1.5e-5 of its group's largest in both dtypes)
FR_PLAIN_LOSS_ATOL = {"float32": 1e-5, "bfloat16": 1e-5}
FR_PLAIN_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
# the cached step against the image step on the same batch, fp32: the bars
# of the JAX package's tests/test_fr_cached_stats.py:55-64
FR_CACHED_LOSS_ATOL = 1e-5
FR_CACHED_PARAM_ATOL = 1e-6
# the FR quality certificate (tests/test_quality_demo.py:39-49)
FR_QUALITY_ARGS = ("--epochs", "5", "--folds", "4", "--scenes", "8", "--methods", "5",
                   "--frames", "2", "--batch-size", "16")
FR_QUALITY_MIN = {"cv_plcc": 0.90, "cv_srcc": 0.80, "cv_ktcc": 0.60}


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
    """ms per call of ``fn()`` over ``iters`` back-to-back calls after a
    warm-up (``utils.benchtime.bench_op`` on the card)."""
    from nerf_qa_torch.utils.benchtime import bench_op

    return 1e3 * bench_op(lambda _: fn(), torch.empty(0, device="cuda"), iters)


def moments_bound(shape, itemsize: int) -> tuple[float, str]:
    """Least time for one moments call: both inputs read once, the (N, 5,
    C) fp32 sums written once; 5 multiply-adds per element pair at the
    fp32 rate."""
    n, h, w, c = shape
    elems = n * h * w * c
    t_bytes = (2 * elems * itemsize + n * 5 * c * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = 10 * elems / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    ``NRTrainer.train_step``, ``"fr.*"`` in ``models/fr.pair_stats`` and
    ``FRTrainer``): each range's host span, and the device time
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
             and str(e.get("name", "")).startswith(("nr.", "fr."))]
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


def make_trainer(vgg, weights, decoder_dtype: str, vit, jbu, lr: float = TRAIN_LR):
    """NRTrainer at full width: ViT-S/14 depth 12 and the JBU stack as
    given (seeded random), decoder depths 2 / 2 with dropout 0.2, the
    CLI's bf16 VGG, a fresh decoder and Adam at ``lr``."""
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig, TrainConfig
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.train.nr_train import NRTrainer

    cfg = NRModelConfig(decoder_dtype=decoder_dtype,
                        dists=DISTSConfig(compute_dtype="bfloat16"))
    model = NRModel(vgg, weights, cfg, vit=vit, jbu=jbu)
    trainer = NRTrainer(model, TrainConfig(lr=lr, schedule="constant",
                                           batch_size=TRAIN_BATCH), steps_per_epoch=1)
    trainer.init(seed=0)
    return trainer


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms inside the block (the repeat of
    ``nr_train_path``'s kernels step)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def step_grads(trainer, batch, gen_state, deterministic: bool = False,
               **kw) -> tuple[dict, dict]:
    """The losses and decoder gradients of one training step's forward and
    backward (no update), the dropout generator at ``gen_state``, ``kw``
    passed to ``losses`` (a score map, cached tokens); with
    ``deterministic``, under cuDNN's deterministic algorithms."""
    model = trainer.model
    trainer.generator.set_state(gen_state)
    model.decoder.train().zero_grad(set_to_none=True)
    algos = deterministic_convs() if deterministic else contextlib.nullcontext()
    with model.train_precision(), algos:
        losses = model.losses(*batch, generator=trainer.generator, **kw)
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
        gaps = grad_gaps(k_grads, p_grads)
        worst = max(gaps, key=gaps.get)
        if not (loss_gap <= TRAIN_PLAIN_LOSS_ATOL[dtype]
                and gaps[worst] <= TRAIN_PLAIN_GRAD_RTOL[dtype]):
            raise AssertionError(f"NR training ({dtype}) kernels vs plain: loss gap "
                                 f"{loss_gap}, gradient {worst} {gaps[worst]}")
        # repeatability: the kernels' step twice under cuDNN's deterministic
        # algorithms is bit-equal (a race in a kernel would break it); each
        # step again as above, the spread of what cuDNN's algorithms alone
        # change between two calls
        a, b = (step_grads(trainer, batch, state, deterministic=True)[1] for _ in range(2))
        if not all(torch.equal(a[n], b[n]) for n in a):
            raise AssertionError(f"NR training ({dtype}): the kernels' step is not "
                                 "repeatable under cuDNN's deterministic algorithms")
        spread = {"kernels": max(grad_gaps(step_grads(trainer, batch, state)[1],
                                           k_grads).values())}
        with plain_versions(model):
            spread["plain"] = max(grad_gaps(step_grads(trainer, batch, state)[1],
                                            p_grads).values())
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
              kernels_vs_plain_worst_grad=[worst, gaps[worst]],
              deterministic_repeat_bit_equal=True, nondeterministic_repeat_spread=spread,
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


def grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """Per tensor, max |got − want| over the tensor's largest |want|."""
    return {n: float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30)
            for n in want}


# a decoder gradient under this share of the decoder's largest is not
# resolved per tensor: a conv bias in front of a training-mode BatchNorm has
# a true gradient of 0 (the batch statistics remove any per-channel shift),
# so two reduction orders give noise there (tests/torch_nr_versions.py)
RESOLVED = 1e-2


def resolved_grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """grad_gaps with each tensor's scale floored at RESOLVED of the
    largest |want| of all: unchanged for every resolved tensor, and the
    smallest resolved tensor's scale for the rest."""
    floor = RESOLVED * max(float(w.abs().max()) for w in want.values())
    return {n: float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), floor)
            for n in want}


def nr_backbones():
    """The seeded random full-width encoder parts shared by the NR phases:
    bf16 DISTS α/β, ViT-S/14 depth 12 and the JBU stack."""
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_jbu_params,
        resolve_vit_params,
    )
    from nerf_qa_torch.config import DISTSConfig

    return (resolve_dists_weights(DISTSConfig(compute_dtype="bfloat16")),
            resolve_vit_params(depth=12, seed=0), resolve_jbu_params(seed=1))


def train_batch(gen, n: int = TRAIN_BATCH, hw: int = 256, sem: int = 224):
    """(gt, render, render at sem²) made on the card."""
    from nerf_qa_torch.ops.resize import resize_bilinear

    gt = torch.rand((n, hw, hw, 3), generator=gen, device="cuda")
    render = (gt + 0.05 * torch.randn(gt.shape, generator=gen, device="cuda")).clamp(0, 1)
    return gt, render, resize_bilinear(render, sem, sem)


def turns(step, variants, plain_model, n_steps: int) -> dict[str, list[float]]:
    """Steps per second of ``step()`` in turns over ``variants`` ('kernels'
    or 'plain', the latter with every plain version), CUDA-event timed."""
    rates = {v: [] for v in dict.fromkeys(variants)}
    for v in variants:
        ctx = plain_versions(plain_model) if v == "plain" else contextlib.nullcontext()
        with ctx:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_steps):
                step()
            end.record()
            end.synchronize()
        rates[v].append(n_steps / (start.elapsed_time(end) / 1e3))
    return rates


def nr_scoremap_train(vgg, gen) -> dict[str, dict]:
    """Phase nr_scoremap_train: the score-map objective
    (``NRTrainer.train_step_score_map``) at full width, batch 4, for both
    decoder dtypes, on renders and ground truths made on the card from a
    seeded generator and their -log10 ADISTS maps (prep_nr's
    ``log_score_map``, on the card): launches per step (4 JBU, 18 + 18
    ChannelNorm, 0 T/S: the loss's ADISTS takes the plain T/S), kernels
    against every plain version to the NR training bars
    (``scoremap_kernels_ok``; the fp32 decoder's step compared in true
    fp32, its VGG too, whose bf16 rounding of the predicted image no fp32
    bar could hold), ``score_map_l1`` and ``combined`` falling, frames/s
    in turns, the ``nr.*`` ranges with ``nr.score_map``, peak memory; then
    the card's fp32 step against the CPU path at a small depth."""
    from nerf_qa_torch.config import ADISTSConfig
    from nerf_qa_torch.tools.prep_nr import log_score_map

    weights, vit, jbu = nr_backbones()
    batch = train_batch(gen)
    # the target prep_nr would write for these pairs: the -log10 ADISTS map
    # of (gt, render), here as floats (channel 1 of a 3-channel map)
    logm = torch.from_numpy(log_score_map(vgg.cuda(), batch[0], batch[1],
                                          ADISTSConfig(compute_dtype="bfloat16"))).cuda()
    score_map = logm[..., None].expand(-1, -1, -1, 3).contiguous()
    out = {}
    for dtype in TRAIN_DTYPES[::-1]:  # fp32, the tight bars, first
        trainer = make_trainer(vgg, weights, dtype, vit, jbu, SCOREMAP_LR)
        model = trainer.model

        def det_losses():
            with torch.no_grad():
                losses = model.losses(*batch, score_map=score_map)
            return {k: float(losses[k]) for k in ("score_map_l1", "combined")}

        def step():
            return trainer.train_step_score_map(*batch, score_map)

        before = det_losses()
        step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        counted = [float(step()["combined"]) for _ in range(TRAIN_COUNTED)]
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: v * TRAIN_COUNTED for k, v in SCOREMAP_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"score-map training ({dtype}) launches {counts}, "
                                 f"expected {want}")
        state = trainer.generator.get_state()
        cfg = model.cfg
        if dtype == "float32":  # compared in true fp32, the VGG too
            model.cfg = cfg.replace(dists=cfg.dists.replace(compute_dtype="float32"))
        ok, vs_plain = scoremap_kernels_ok(dtype, trainer, batch, state, score_map=score_map)
        model.cfg = cfg
        if not ok:
            raise AssertionError(f"score-map training ({dtype}) kernels vs plain: {vs_plain}")
        rates = turns(step, ("kernels", "plain", "plain", "kernels"), model, TRAIN_TIMED)
        prof = profile_step(step)
        if set(prof.get("layers_device_ms", ())) != set(TRAIN_LAYERS) | {"score_map_ms"}:
            raise AssertionError(f"score-map training ({dtype}) profiler ranges {prof}")
        after = det_losses()
        if not all(math.isfinite(after[k]) and after[k] < before[k] for k in before):
            raise AssertionError(f"score-map training ({dtype}) losses {before} -> {after}")
        phase("nr_scoremap_train", decoder_dtype=dtype, vgg_dtype="bfloat16",
              batch=TRAIN_BATCH, vit_depth=12, decoder_depths=[2, 2], dropout=0.2,
              lr=SCOREMAP_LR, steps=trainer.step, launches=counts,
              launches_per_step={k: v // TRAIN_COUNTED for k, v in counts.items()},
              counted_step_losses=counted, det_losses_before=before,
              det_losses_after=after,
              kernels_vs_plain_vgg_dtype="float32" if dtype == "float32" else "bfloat16",
              kernels_vs_plain=vs_plain, loss_atol=TRAIN_PLAIN_LOSS_ATOL[dtype],
              grad_rtol=TRAIN_PLAIN_GRAD_RTOL[dtype],
              steps_per_s=rates, frames_per_s={k: [TRAIN_BATCH * r for r in v]
                                               for k, v in rates.items()},
              peak_mem_gib=peak, **prof)
        out[dtype] = counts
        del trainer, model
        torch.cuda.empty_cache()
    scoremap_cpu_parity(gen)
    return out


def decoder_vjp(trainer, batch, state, cotangents=None, **kw):
    """One training step's forward and backward (no update), the dropout
    generator at ``state``. Returns the losses; the decoder's outputs (the predicted image and feature
    maps, and the regression map where there is one); the loss's gradient
    with respect to them, its cotangents; and the decoder's parameter
    gradients for those cotangents (``own``, the step's own gradient) and,
    with ``cotangents`` given, for those (``shared``)."""
    model = trainer.model
    outs = []
    hook = model.decoder.register_forward_hook(lambda mod, args, out: outs.append(out))
    trainer.generator.set_state(state)
    model.decoder.train().zero_grad(set_to_none=True)
    grads = {}

    def take(name):
        grads[name] = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                       for n, p in model.decoder.named_parameters()}
        model.decoder.zero_grad(set_to_none=True)

    try:
        with model.train_precision():
            losses = model.losses(*batch, generator=trainer.generator, **kw)
            predicted, reg_map = outs[0]
            flat = [t for t in (*predicted, reg_map) if t is not None]
            own = torch.autograd.grad(losses["combined"], flat, retain_graph=True,
                                      allow_unused=True)
            own = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, own)]
            torch.autograd.backward(flat, own, retain_graph=cotangents is not None)
            take("own")
            if cotangents is not None:
                torch.autograd.backward(flat, cotangents)
                take("shared")
    finally:
        hook.remove()
    trainer.generator.set_state(state)
    return ({k: float(v.detach()) for k, v in losses.items()},
            [t.detach() for t in flat], own, grads)


def rel_l2(got, want) -> float:
    """The L2 distance of two lists or dicts of tensors over all their
    elements, relative to the L2 norm of ``want``."""
    if isinstance(want, dict):
        got, want = [got[n] for n in want], list(want.values())
    num = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    return math.sqrt(num / max(sum(float(w.double().square().sum()) for w in want), 1e-300))


def scoremap_kernels_ok(dtype, trainer, batch, state, **kw) -> tuple[bool, dict]:
    """The score-map step, the kernels against every plain version, to the
    NR training bars (TRAIN_PLAIN_LOSS_ATOL, TRAIN_PLAIN_GRAD_RTOL): every
    loss, and each decoder gradient relative to its largest value. The
    gradients are the decoder's backward, kernels and plain, of one shared
    cotangent, the plain step's gradient of the loss with respect to the
    decoder's outputs: the score-map loss's own gradient with respect to
    the predicted image changes far more than the image does (the clamp
    to [0, 1], the bf16 VGG of the ADISTS map, its min/max
    normalisations and var/mean ratios, -log10), so each step's own
    gradient carries that change, which is not the kernels'. The phase
    reports the decoder outputs' distance, the cotangents' and the own
    gradients' (whole-gradient L2 relative to the norm). Returns (ok, the
    figures)."""
    model = trainer.model
    with plain_versions(model):
        pl, p_out, p_cot, pg = decoder_vjp(trainer, batch, state, **kw)
    kl, k_out, k_cot, kg = decoder_vjp(trainer, batch, state, p_cot, **kw)
    loss_gaps = {k: abs(kl[k] - pl[k]) for k in pl}
    gaps = grad_gaps(kg["shared"], pg["own"])
    worst = max(gaps, key=gaps.get)
    own = grad_gaps(kg["own"], pg["own"])
    own_worst = max(own, key=own.get)
    ok = (max(loss_gaps.values()) <= TRAIN_PLAIN_LOSS_ATOL[dtype]
          and gaps[worst] <= TRAIN_PLAIN_GRAD_RTOL[dtype])
    return ok, {"loss_gaps": loss_gaps, "worst_grad": [worst, gaps[worst]],
                "grad_l2": rel_l2(kg["shared"], pg["own"]),
                "outputs_l2": rel_l2(k_out, p_out),
                "outputs_max_of_largest": max(
                    float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)
                    for k, p in zip(k_out, p_out)),
                "cotangents_l2": rel_l2(k_cot, p_cot),
                "own_grad_l2": rel_l2(kg["own"], pg["own"]),
                "own_worst_grad": [own_worst, own[own_worst]]}


def small_nr(cfg, decoder_seed: int = 3):
    """An NR model at 64² / 56² (ViT depth 2) with a seeded decoder built
    as the trainers build it, for card-against-CPU checks."""
    from nerf_qa_torch.compat.pretrained import (
        resolve_dists_weights,
        resolve_jbu_params,
        resolve_vgg_params,
        resolve_vit_params,
    )
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.layers import init_lecun_normal_
    from nerf_qa_torch.models.nr.model import NRModel

    decoder = init_lecun_normal_(NRDecoder(cfg, qkv_bias=True, layer_scale=True),
                                 torch.Generator().manual_seed(decoder_seed))
    return NRModel(resolve_vgg_params(seed=0), resolve_dists_weights(cfg.dists), cfg,
                   vit=resolve_vit_params(depth=2, grid_size=4, seed=0),
                   jbu=resolve_jbu_params(seed=1) if cfg.version >= 7 else None,
                   decoder=decoder, render_size=64, sem_size=56)


def train_mode_step(model, args, kwargs) -> tuple[dict, dict, dict, dict]:
    """One fp32 training-mode step's forward and backward (no generator:
    no dropout): the losses, the decoder's gradients and its BatchNorm
    running averages (on the CPU), and the launches."""
    reset_launches()
    model.decoder.train()
    with model.train_precision():
        losses = model.losses(*args, **kwargs)
        losses["combined"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
             for n, p in model.decoder.named_parameters()},
            {k: v.cpu() for k, v in model.decoder.state_dict().items()
             if k.endswith(("running_mean", "running_var"))},
            launch_counts())


def card_and_cpu_steps(small, batch, **kw) -> tuple[tuple, tuple]:
    """``train_mode_step`` on the card (every kernel on) and on the CPU
    from the same weights: (card, CPU)."""
    on_cpu = copy.deepcopy(small)
    card = train_mode_step(small.to("cuda"), batch, kw)
    cpu = train_mode_step(on_cpu, [t.cpu() for t in batch], {k: v.cpu() for k, v in kw.items()})
    if any(cpu[3].values()):
        raise AssertionError(f"CPU launches {cpu[3]}")
    return card, cpu


def step_gaps(got, want) -> dict:
    """Two ``train_mode_step`` results apart: the largest loss gap; per
    decoder gradient tensor the largest gap relative to its largest value;
    the whole gradient's L2 gap relative to its norm; the running averages'
    largest gaps relative to their largest values."""
    (kl, kg, kst, _), (cl, cg, cst, _) = got, want
    top = max(float(g.abs().max()) for g in cg.values())
    gaps = {}
    for n in cg:
        scale = float(cg[n].abs().max())
        # a tensor below 1 % of the largest |grad| is not resolved on its
        # own (a conv bias in front of a batch-statistics BatchNorm has a
        # zero true gradient): it is held to a tenth of the bar at the
        # largest |grad| (the CPU tests' rule, tests/torch_nr_versions.py)
        gaps[n] = float((kg[n] - cg[n]).abs().max()) / (scale if scale >= 1e-2 * top
                                                         else 1e-1 * top)
    worst = max(gaps, key=gaps.get)
    return {"loss_gap": max(abs(kl[k] - cl[k]) for k in kl),
            "worst_grad": [worst, gaps[worst]], "grad_l2": rel_l2(kg, cg),
            "running_stats_gap": max((float((kst[k] - cst[k]).abs().max())
                                      / max(float(cst[k].abs().max()), 1e-30)
                                      for k in cst), default=0.0)}


def scoremap_cpu_parity(gen) -> None:
    """Phase nr_scoremap_cpu_parity: the score-map loss's fp32 training
    step at 64² / 56² on the card against the port's CPU path: losses
    within SCORE_ATOL, gradients per tensor within TRAIN_CPU_GRAD_RTOL."""
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig

    cfg = NRModelConfig(transformer_decoder_depth=1, decoder_dtype="float32",
                        dists=DISTSConfig(compute_dtype="float32"))
    batch = train_batch(gen, 2, 64, 56)
    sm = 1.0 + 1.5 * torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    card, cpu = card_and_cpu_steps(small_nr(cfg), batch, score_map=sm)
    gaps, counts = step_gaps(card, cpu), card[3]
    if (gaps["loss_gap"] > SCORE_ATOL or gaps["worst_grad"][1] > TRAIN_CPU_GRAD_RTOL
            or min(counts[k] for k in ("jbu", "channelnorm", "channelnorm_bwd")) == 0
            or counts["windowed_tsd"]):
        raise AssertionError(f"score-map card vs CPU: {gaps}, launches {counts}")
    phase("nr_scoremap_cpu_parity", hw=[64, 56], vit_depth=2, decoder_depths=[1, 2],
          losses=card[0], loss_gap=gaps["loss_gap"], worst_grad=gaps["worst_grad"],
          grad_l2_gap=gaps["grad_l2"], grad_rtol=TRAIN_CPU_GRAD_RTOL, launches=counts)


def dropout_masks(masks: list):
    """Record every Dropout2d mask drawn inside the block (per sample and
    channel: kept or not), in draw order."""
    from nerf_qa_torch.models.nr import layers

    real = layers.Dropout2d.forward

    def record(self, x, generator=None):
        y = real(self, x, generator)
        if generator is not None and self.training and self.rate:
            masks.append((y != 0).flatten(2).any(-1).cpu())
        return y

    layers.Dropout2d.forward = record
    return _restoring(layers.Dropout2d, "forward", real)


def recomputed_in_order(forward: list, recomputed: list) -> bool:
    """Whether the backward's recomputation drew each stage's masks again:
    the stages (three dropout layers each, two in the last) recompute last
    to first."""
    per_stage = [3] * 5 + [2]
    if len(forward) != sum(per_stage) or len(recomputed) != len(forward):
        return False
    starts = np.cumsum([0] + per_stage)
    rev = np.cumsum([0] + per_stage[::-1])
    for i in range(6):
        j = 5 - i
        want = forward[starts[i]:starts[i + 1]]
        got = recomputed[rev[j]:rev[j + 1]]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            return False
    return True


@contextlib.contextmanager
def _restoring(obj, name, value):
    try:
        yield
    finally:
        setattr(obj, name, value)


def nr_remat(vgg, gen) -> dict[str, int]:
    """Phase nr_remat: the bf16 training step at full width with
    ``remat=True`` and ``remat=False`` from one generator state: losses and
    gradients equal to REMAT_RTOL of the largest, the dropout masks equal
    (the recomputation draws the forward's), launches per remat step (18
    ChannelNorm forward + 17 recomputed: every stage's ChannelNorms but
    trans2sem's, which sits outside the checkpoints; 18 backward; 4 JBU),
    and each variant's peak memory and step time."""
    weights, vit, jbu = nr_backbones()
    batch = train_batch(gen)
    trainer = make_trainer(vgg, weights, "bfloat16", vit, jbu)
    model = trainer.model
    base_cfg = model.decoder.cfg
    trainer.train_step(*batch)  # warm-up
    state = trainer.generator.get_state()
    res = {}
    for remat in (False, True):  # the same weights and generator state
        model.decoder.cfg = base_cfg.replace(remat=remat)
        masks = []
        with dropout_masks(masks):
            losses, grads = step_grads(trainer, batch, state)
        res[remat] = dict(losses=losses, grads=grads, masks=masks,
                          gen_after=trainer.generator.get_state())
    for remat in (False, True):  # then steps: launches, memory, time
        model.decoder.cfg = base_cfg.replace(remat=remat)
        trainer.generator.set_state(state)
        reset_launches()
        trainer.train_step(*batch)
        counts = launch_counts()
        trainer.generator.set_state(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        rate = turns(lambda: trainer.train_step(*batch), ("kernels",) * 2, model,
                     TRAIN_TIMED)["kernels"]
        res[remat].update(counts=counts, peak=peak, ms=[1e3 / r for r in rate])
    plain, rem = res[False], res[True]
    scale = max(float(g.abs().max()) for g in plain["grads"].values())
    grad_gap = max(float((rem["grads"][n] - plain["grads"][n]).abs().max())
                   for n in plain["grads"]) / scale
    loss_gap = max(abs(rem["losses"][k] - plain["losses"][k])
                   / max(abs(plain["losses"][k]), 1e-30) for k in plain["losses"])
    n_fwd = len(plain["masks"])
    same_masks = (len(rem["masks"]) == 2 * n_fwd - 1 and all(
        torch.equal(a, b) for a, b in zip(rem["masks"][:n_fwd], plain["masks"])))
    recomputed = rem["masks"][n_fwd:]
    same_recompute = recomputed_in_order(plain["masks"][1:], recomputed)
    want = dict(REMAT_LAUNCHES)
    if not (grad_gap <= REMAT_RTOL and loss_gap <= REMAT_RTOL and same_masks
            and same_recompute and torch.equal(rem["gen_after"], plain["gen_after"])
            and rem["counts"] == want and plain["counts"]["channelnorm"] == NR_CN_PER_BATCH):
        raise AssertionError(f"remat: loss gap {loss_gap}, gradient gap {grad_gap}, masks "
                             f"{same_masks, same_recompute}, launches {rem['counts']} "
                             f"(expected {want}), plain {plain['counts']}")
    phase("nr_remat", decoder_dtype="bfloat16", batch=TRAIN_BATCH, vit_depth=12,
          loss_rel_gap=loss_gap, grad_gap_of_largest=grad_gap, rtol=REMAT_RTOL,
          dropout_masks=n_fwd, recomputed_masks=len(recomputed),
          launches_remat=rem["counts"], launches_plain=plain["counts"],
          step_peak_gib={"remat": rem["peak"], "plain": plain["peak"]},
          step_ms={"remat": rem["ms"], "plain": plain["ms"]})
    del trainer, model
    torch.cuda.empty_cache()
    return rem["counts"]


def nr_versions(vgg, gen) -> None:
    """Phase nr_versions: v1-v6 at full width (ViT-S/14 depth 12, decoder
    depths 2 / 2, bf16 VGG and mixer, batch 4): one scoring batch (moments
    kernel, 6 launches, against eager statistics within SCORE_ATOL) and one
    training step (forward, losses with the v6 targets, backward, Adam,
    the BatchNorm running averages updated), 0 JBU and 0 ChannelNorm
    launches (and no moments launch for v4, which computes no DISTS),
    frames/s; then each version's fp32 training step on the card
    against the port's CPU path at 64² / 56²."""
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.train.nr_train import NRTrainer
    from nerf_qa_torch.config import TrainConfig

    weights, vit, _ = nr_backbones()
    gt, render, r224 = train_batch(gen)
    std = torch.full((TRAIN_BATCH,), 0.05, device="cuda")
    mean = torch.full((TRAIN_BATCH,), 0.3, device="cuda")
    rows = {}
    for v in range(1, 7):
        kernel = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
        eager = kernel.replace(stats_impl="eager")
        cfg = NRModelConfig(version=v, decoder_dtype="bfloat16", dists=kernel)
        model = NRModel(vgg, weights, cfg, vit=vit).to("cuda")
        with torch.no_grad():
            model(render, r224)  # warm-up
            reset_launches()
            s_k = model(render, r224)
            score_counts = launch_counts()
            model.cfg = cfg.replace(dists=eager)
            s_e = model(render, r224)
        gap = float((s_k - s_e).abs().max())
        score_rate = turns(lambda: _score(model, render, r224, kernel),
                           ("kernels",) * 2, model, 3)["kernels"]
        model.cfg = cfg.replace(dists=eager)
        trainer = NRTrainer(model, TrainConfig(lr=TRAIN_LR, schedule="constant",
                                               batch_size=TRAIN_BATCH), steps_per_epoch=1)
        trainer.init(seed=0)
        stats0 = {k: t.clone() for k, t in model.decoder.state_dict().items()
                  if k.endswith("running_mean")}
        reset_launches()
        losses = trainer.train_step(gt, render, r224, std, mean)
        train_counts = launch_counts()
        moved = all(not torch.equal(t, model.decoder.state_dict()[k])
                    for k, t in stats0.items())
        train_rate = turns(lambda: trainer.train_step(gt, render, r224, std, mean),
                           ("kernels",) * 2, model, 3)["kernels"]
        want_score = dict(VERSION_SCORE_LAUNCHES, moments=0 if v == 4 else 6)
        ok = (gap <= SCORE_ATOL and bool(torch.isfinite(s_k).all()) and moved and stats0
              and score_counts == want_score
              and train_counts == dict(VERSION_TRAIN_LAUNCHES)
              and all(math.isfinite(float(x)) for x in losses.values()))
        if not ok:
            raise AssertionError(f"NR v{v}: kernel vs eager {gap}, stats moved {moved}, "
                                 f"launches {score_counts} / {train_counts}, losses {losses}")
        rows[f"v{v}"] = dict(score_gap=gap, scores=s_k.tolist(),
                             losses={k: float(x) for k, x in losses.items()},
                             score_launches=score_counts, train_launches=train_counts,
                             batchnorms=len(stats0),
                             score_frames_per_s=[TRAIN_BATCH * r for r in score_rate],
                             train_frames_per_s=[TRAIN_BATCH * r for r in train_rate])
        del trainer, model
        torch.cuda.empty_cache()
    phase("nr_versions", batch=TRAIN_BATCH, vit_depth=12, decoder_depths=[2, 2],
          vgg_dtype="bfloat16", decoder_dtype="bfloat16", score_atol=SCORE_ATOL,
          versions=rows)
    versions_cpu_parity()


def _score(model, render, r224, cfg):
    model.cfg = model.cfg.replace(dists=cfg)
    with torch.no_grad():
        return model(render, r224)


def unbiased_batchnorm():
    """Inside the block, BatchNorm in training mode normalises with the
    unbiased batch variance (``Tensor.var``'s default) in place of flax's
    biased one: the fault that ``versions_cpu_parity`` must fail on."""
    from nerf_qa_torch.models.nr import layers

    real = layers.BatchNorm.forward

    def forward(self, x, shard=None):
        real(self, x, shard)  # the running averages move as flax moves them
        xf = x.float()
        mean, var = xf.mean(dim=(0, 2, 3)), xf.var(dim=(0, 2, 3))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(self.dtype)

    layers.BatchNorm.forward = forward
    return _restoring(layers.BatchNorm, "forward", real)


def versions_cpu_parity() -> None:
    """Phase nr_versions_cpu_parity: for v1-v6, one fp32 training-mode
    step's forward and backward (no generator: no dropout; BatchNorm on
    the batch's statistics) on the card against the port's CPU path at
    64² / 56² (ViT depth 2, decoder depths 1 / 2), on inputs from a seed
    of their own (VERSION_SEED): losses within SCORE_ATOL, the running
    averages after it within VERSION_STATS_RTOL, the decoder gradient per
    tensor within VERSION_GRAD_RTOL (``step_gaps``) and as a whole within
    VERSION_GRAD_L2. The same figures for the CPU step with the fault
    ``unbiased_batchnorm`` against the CPU step: the gradient bars must
    fail on it."""
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig

    batch = train_batch(torch.Generator(device="cuda").manual_seed(VERSION_SEED), 2, 64, 56)
    kw = {"score_std": torch.tensor([0.05, 0.06], device="cuda"),
          "score_mean": torch.tensor([0.3, 0.35], device="cuda")}

    def grads_pass(g):
        return g["worst_grad"][1] <= VERSION_GRAD_RTOL and g["grad_l2"] <= VERSION_GRAD_L2

    rows = {}
    for v in range(1, 7):
        cfg = NRModelConfig(version=v, transformer_decoder_depth=1, decoder_dtype="float32",
                            dists=DISTSConfig(compute_dtype="float32"))
        small = small_nr(cfg)
        on_cpu = copy.deepcopy(small)
        card, cpu = card_and_cpu_steps(small, batch, **kw)
        gaps = step_gaps(card, cpu)
        with unbiased_batchnorm():
            fault = step_gaps(train_mode_step(on_cpu, [t.cpu() for t in batch],
                                              {k: t.cpu() for k, t in kw.items()}), cpu)
        if not (gaps["loss_gap"] <= SCORE_ATOL and grads_pass(gaps)
                and gaps["running_stats_gap"] <= VERSION_STATS_RTOL
                and not any(card[3].values()) and not grads_pass(fault)):
            raise AssertionError(f"NR v{v} card vs CPU: {gaps}, launches {card[3]}; "
                                 f"the unbiased-variance fault {fault}")
        rows[f"v{v}"] = dict(gaps, unbiased_variance_fault=fault)
    phase("nr_versions_cpu_parity", hw=[64, 56], vit_depth=2, decoder_depths=[1, 2],
          seed=VERSION_SEED, loss_atol=SCORE_ATOL, grad_rtol=VERSION_GRAD_RTOL,
          grad_l2=VERSION_GRAD_L2, stats_rtol=VERSION_STATS_RTOL, versions=rows)


def nr_feature_cache(vgg, gen) -> None:
    """Phase nr_feature_cache: ``tools.cache_nr_features`` on a synthetic
    tree on the card (ViT-S/14 depth 12), then a training step on cached
    tokens against the uncached step from the same decoder, generator and
    canonical (un-augmented) frames: losses within CACHE_ATOL (fp16
    tokens; the JAX package's bar), and both steps timed."""
    import io

    from nerf_qa_torch.data.datasets import NerfNRQADataset
    from nerf_qa_torch.data.feature_cache import TokenCacheReader
    from nerf_qa_torch.tools import cache_nr_features
    from nerf_qa_torch.tools.make_synthetic_dataset import make_nr_tree
    from nerf_qa_torch.tools.train_nr import read_rows

    weights, vit, jbu = nr_backbones()
    with tempfile.TemporaryDirectory() as tmp:
        csv = make_nr_tree(f"{tmp}/data", scenes=("chair", "drums"), methods=("nerfacto",),
                           frames=4, hw=(96, 128))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cache_nr_features.main(["--data-dir", f"{tmp}/data", "--scores-csv", csv,
                                         "--cache-dir", f"{tmp}/cache", "--num-workers",
                                         "2", "--batch-size", "4"])
        cache_s = time.perf_counter() - t0
        rows = read_rows(csv)
        items = [NerfNRQADataset(rows, f"{tmp}/data", mode="gt")[i] for i in range(4)]
        reader = TokenCacheReader(f"{tmp}/cache", rows)
        got, total = reader.coverage()
        toks = torch.from_numpy(reader.gather([it[4] for it in items],
                                               [it[5] for it in items])).cuda()
    gt = torch.from_numpy(np.stack([it[0] for it in items])).cuda()
    r256 = torch.from_numpy(np.stack([it[1]["256x256"] for it in items])).cuda()
    r224 = torch.from_numpy(np.stack([it[1]["224x224"] for it in items])).cuda()
    trainer = make_trainer(vgg, weights, "bfloat16", vit, jbu)
    trainer.train_step(gt, r256, r224)  # warm-up
    state = trainer.generator.get_state()
    direct, _ = step_grads(trainer, (gt, r256, r224), state)
    cached, _ = step_grads(trainer, (gt, r256, r224), state, sem_tokens=toks)
    gap = max(abs(direct[k] - cached[k]) for k in direct)
    rates = {}
    for name, kw in (("direct", {}), ("cached", {"sem_tokens": toks}),
                     ("cached", {"sem_tokens": toks}), ("direct", {})):
        rates.setdefault(name, []).extend(turns(
            lambda: trainer.train_step(gt, r256, r224, **kw), ("kernels",), trainer.model,
            TRAIN_TIMED)["kernels"])
    if rc != 0 or (got, total) != (2, 2) or gap > CACHE_ATOL:
        raise AssertionError(f"feature cache: rc {rc}, coverage {got}/{total}, loss gap "
                             f"{gap}")
    phase("nr_feature_cache", videos=total, frames=8, cache_build_s=cache_s,
          tokens_shape=list(toks.shape), loss_gap=gap, atol=CACHE_ATOL,
          direct_losses=direct, cached_losses=cached,
          steps_per_s=rates, frames_per_s={k: [TRAIN_BATCH * r for r in v]
                                           for k, v in rates.items()},
          log=out.getvalue().strip().splitlines()[-1])
    del trainer
    torch.cuda.empty_cache()


def nr_cli_full() -> dict[str, int]:
    """Phase nr_cli_full: on a synthetic tree on the card, ``prep_nr
    --score-maps`` (the moments kernel for the DISTS columns, the T/S
    kernel for the maps: PREP_TSD_PER_FRAME launches a frame), its float
    maps against the plain T/S version (SCOREMAP_ATOL) and its PNG levels
    against the plain maps' (within one level); then ``train_nr`` for an
    epoch each with ``--mode score-map``, ``--remat``, ``--feature-cache``
    (after ``cache_nr_features``), ``--test-scores-csv`` (a NeRF-QA-layout
    benchmark of the tree's frame directories) and ``--version 6``; then
    ``score --nr --nr-version 6`` of the last checkpoint. Returns the T/S
    launches of the prep."""
    import io
    import shutil

    from PIL import Image

    from nerf_qa_torch.compat.pretrained import resolve_vgg_params
    from nerf_qa_torch.config import ADISTSConfig
    from nerf_qa_torch.core import adists
    from nerf_qa_torch.data.imaging import load_image_rgb, resize_image
    from nerf_qa_torch.tools import cache_nr_features, prep_nr, score, train_nr
    from nerf_qa_torch.tools.make_synthetic_dataset import make_nr_tree

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        make_nr_tree(data, scenes=("chair", "drums", "room"),
                     methods=("nerfacto", "instant-ngp"), frames=4, hw=(96, 128))
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = prep_nr.main(["--data-dir", data, "--score-maps"])
        prep_s = time.perf_counter() - t0
        prep_counts = launch_counts()
        frames = 3 * 2 * 4
        if rc != 0 or prep_counts["windowed_tsd"] != PREP_TSD_PER_FRAME * frames \
                or prep_counts["moments"] == 0:
            raise AssertionError(f"prep_nr: rc {rc}, launches {prep_counts}")
        # the float maps, kernel against plain, and the PNG levels
        vgg = resolve_vgg_params(seed=0).cuda()
        map_err, level_err = 0.0, 0
        for scene in ("chair", "drums", "room"):
            for method in ("nerfacto", "instant-ngp"):
                color = f"{data}/{scene}/{method}/color"
                for name in sorted(os.listdir(color)):
                    r = resize_image(load_image_rgb(f"{color}/{name}"), 256, 256)
                    g = resize_image(load_image_rgb(f"{data}/{scene}/gt/{name}"), 256, 256)
                    x, y = (torch.from_numpy(a[None]).cuda() for a in (g, r))
                    cfg = ADISTSConfig(compute_dtype="bfloat16")
                    with torch.no_grad():
                        k_map = adists.forward(vgg, x, y, cfg, as_map=True)
                        p_map = adists.forward(vgg, x, y, cfg.replace(fused_tsd=False),
                                               as_map=True)
                    map_err = max(map_err, float((k_map - p_map).abs().max()))
                    enc, _, _ = prep_nr.encode_log_map(
                        -np.log10(np.clip(p_map[0].cpu().numpy(), 1e-6, None)))
                    png = np.asarray(Image.open(f"{data}/{scene}/{method}/score-map/{name}"),
                                     np.int32)
                    level_err = max(level_err, int(np.abs(png - enc.astype(np.int32)).max()))
        if map_err > SCOREMAP_ATOL or level_err > 1:
            raise AssertionError(f"prep_nr maps: kernel vs plain {map_err}, PNG levels "
                                 f"{level_err}")
        csv = f"{data}/output.csv"
        # a NeRF-QA-layout benchmark over the tree's render directories
        bench = f"{tmp}/bench"
        with open(f"{bench}.csv", "w") as f:
            f.write("reference_filename,distorted_filename,MOS,DMOS,DISTS\n")
            for i, (scene, method, ref) in enumerate((
                    ("chair", "nerfacto", "lego"), ("drums", "nerfacto", "ship"),
                    ("room", "instant-ngp", "truck"), ("chair", "instant-ngp", "m60"))):
                shutil.copytree(f"{data}/{scene}/{method}/color", f"{bench}/v{i}")
                f.write(f"{ref}_reference.mp4,v{i}.mp4,{1 + i},{5 - 0.5 * i},"
                        f"{0.1 + 0.05 * i}\n")
        with contextlib.redirect_stdout(out):
            rc_cache = cache_nr_features.main(["--data-dir", data, "--scores-csv", csv,
                                               "--cache-dir", f"{tmp}/cache",
                                               "--num-workers", "2"])
        common = ["--data-dir", data, "--scores-csv", csv, "--epochs", "1",
                  "--batch-size", str(TRAIN_BATCH), "--num-workers", "2"]
        runs = {
            "score-map": ["--mode", "score-map"],
            "remat": ["--remat"],
            "feature-cache": ["--feature-cache", f"{tmp}/cache"],
            "test-scores-csv": ["--test-scores-csv", f"{bench}.csv", "--test-data-dir",
                                bench, "--test-every", "1", "--test-max-frames", "4"],
            "version-6": ["--version", "6"],
        }
        for name, flags in runs.items():
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc_run = train_nr.main(common + ["--output-dir", f"{tmp}/run-{name}",
                                                 *flags])
            counts = launch_counts()
            with open(f"{tmp}/run-{name}/metrics.jsonl") as f:
                logs = [json.loads(line) for line in f]
            keys = set().union(*logs)
            want_kernels = (("jbu", "channelnorm", "channelnorm_bwd") if name != "version-6"
                            else ())
            ok = (rc_run == 0 and rc_cache == 0
                  and all(counts[k] > 0 for k in want_kernels)
                  and (name != "version-6" or counts["channelnorm"] == counts["jbu"] == 0)
                  and counts["windowed_tsd"] == 0
                  and (name != "score-map" or "Train Metrics Dict/score_map_l1" in keys)
                  and (name != "test-scores-csv" or "Test Metrics Dict/mos/plcc" in keys))
            if not ok:
                raise AssertionError(f"train_nr {name}: rc {rc_run}, launches {counts}, "
                                     f"keys {sorted(keys)}, output {out.getvalue()[-2000:]}")
            res[name] = dict(seconds=time.perf_counter() - t0, launches=counts,
                             metrics={k: v for k, v in logs[-1].items()
                                      if k.startswith(("Train", "Test"))})
        with contextlib.redirect_stdout(out):
            rc_score = score.main(["--nr", "--nr-ckpt", f"{tmp}/run-version-6/ckpt",
                                   "--nr-version", "6", "--dist",
                                   f"{data}/room/nerfacto/color", "--json",
                                   "--batch-size", "4"])
        result = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc_score != 0 or result["nr"]["frames"] != 4 or not math.isfinite(
            result["nr"]["video_score"]):
        raise AssertionError(f"score --nr v6: rc {rc_score}, {result}")
    phase("nr_cli_full", prep_seconds=prep_s, prep_launches=prep_counts,
          prep_frames=frames, maps_kernel_vs_plain=map_err, maps_atol=SCOREMAP_ATOL,
          png_level_err=level_err, train_runs=res, score_nr_v6=result)
    return prep_counts


def subpixel_choice(gen) -> None:
    """Phase subpixel_choice: the NR decoders' 2x upsample at their shapes,
    batch 4 (v8: bf16 ConvTransposeLayer inputs; v1-v6: the fp32 raw
    transposed convs), forward and forward + backward, as the transposed
    conv and as its sub-pixel form: agreement, times in turns, the totals,
    and the faster form against the port's default on the card, the
    transposed conv (``ops/subpixel.conv_transpose_2x``)."""
    from nerf_qa_torch.ops import subpixel

    shapes = [("v8", torch.bfloat16, cin, cout, hw) for cin, cout, hw in
              ((896, 896, 16), (896, 640, 32), (640, 512, 64), (512, 448, 128))]
    shapes += [("v1-v5", torch.float32, c, c, hw) for c, hw in
               ((896, 16), (896, 32), (448, 64), (224, 128))]
    shapes += [("v6", torch.float32, cin, cout, hw) for cin, cout, hw in
               ((896, 896, 16), (896, 448, 32), (448, 224, 64), (224, 112, 128))]
    forms = {"transpose": subpixel.conv_transpose_2x_dense,
             "subpixel": subpixel.conv_transpose_2x_subpixel}
    rows, tot = [], {f: {"fwd_ms": 0.0, "fwd_bwd_ms": 0.0} for f in forms}
    for gen_name, dt, cin, cout, hw in shapes:
        x = torch.randn((TRAIN_BATCH, cin, hw, hw), generator=gen, device="cuda").to(dt)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn((cin, cout, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cin)
        b = torch.randn((cout,), generator=gen, device="cuda")
        g = torch.randn((TRAIN_BATCH, cout, 2 * hw, 2 * hw), generator=gen,
                        device="cuda").to(dt)
        row = {"decoder": gen_name, "dtype": str(dt).split(".")[-1],
               "shape": [TRAIN_BATCH, cin, hw, hw], "out_chns": cout}
        with true_fp32_if(dt):
            want = forms["transpose"](x, w.to(dt), b).float()
            got = forms["subpixel"](x, w.to(dt), b).float()
            row["max_abs_err"] = float((got - want).abs().max())
            tol = 1e-4 if dt == torch.float32 else 4e-2 * float(want.abs().max())
            if row["max_abs_err"] > tol:
                raise AssertionError(f"subpixel {row}: error over {tol}")
            for f, fn in forms.items():
                xx = x.detach().requires_grad_(True)
                ww = w.to(dt).detach().requires_grad_(True)

                def fwd_bwd():
                    fn(xx, ww, b).backward(g)

                row[f"{f}_fwd_ms"] = time_ms(lambda: fn(x, w.to(dt), b), 10)
                row[f"{f}_fwd_bwd_ms"] = time_ms(fwd_bwd, 10)
            for f in forms:  # the second turn, reversed
                row[f"{f}_fwd_ms_again"] = time_ms(lambda: forms[f](x, w.to(dt), b), 10)
        for f in forms:
            tot[f]["fwd_ms"] += row[f"{f}_fwd_ms"]
            tot[f]["fwd_bwd_ms"] += row[f"{f}_fwd_bwd_ms"]
        rows.append(row)
        del x, w, g
    faster = min(forms, key=lambda f: tot[f]["fwd_bwd_ms"])
    phase("subpixel_choice", batch=TRAIN_BATCH, rows=rows, totals=tot, faster=faster,
          cuda_default="transpose", default_is_faster=faster == "transpose")


def true_fp32_if(dt):
    from nerf_qa_torch.config import true_fp32

    return true_fp32() if dt == torch.float32 else contextlib.nullcontext()


def fr_batch(gen, n: int, hw: int):
    """n (dist, ref) pairs of hw² renders made on the card, the noise level
    rising across the batch, and MOS-like targets that fall with it
    (``make_fr_tree``'s rule) plus seeded noise."""
    ref = torch.rand((n, hw, hw, 3), generator=gen, device="cuda")
    sigma = torch.linspace(0.01, 0.3, n, device="cuda")
    noise = torch.randn(ref.shape, generator=gen, device="cuda")
    dist = (ref + sigma[:, None, None, None] * noise).clamp(0, 1)
    jitter = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    return dist, ref, (5.0 - 12.0 * sigma + jitter).clamp(1, 5)


def make_fr_trainer(vgg, dtype: str, stats_impl: str, device=None, mesh=None):
    """FRTrainer with the CLI's logistic head and the bundled α/β, Adam at
    FR_LR with the CLI's warm-up and exponential schedule (over ``mesh``
    when given)."""
    from nerf_qa_torch.config import DISTSConfig, FRModelConfig, TrainConfig
    from nerf_qa_torch.train.fr_train import FRTrainer

    cfg = FRModelConfig(regression_type="logistic",
                        dists=DISTSConfig(compute_dtype=dtype, stats_impl=stats_impl))
    return FRTrainer(vgg, cfg, TrainConfig(lr=FR_LR, batch_size=FR_BATCH),
                     steps_per_epoch=FR_STEPS_PER_EPOCH, device=device, mesh=mesh)


def fr_grads(trainer, params, dist, ref, targets) -> tuple[float, dict]:
    """One FR step's loss and head and α/β gradients (no update), from
    fresh copies of ``params``."""
    p = trainer.to_device(params)
    loss, _ = trainer.loss_fn(p, dist, ref, targets)
    loss.backward()
    grads = {f"head.{k}": v.grad for k, v in p["head"].items()}
    grads.update(alpha=p["dists"].alpha.grad, beta=p["dists"].beta.grad)
    return float(loss.detach()), grads


def fr_grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """Each gradient's largest gap over the largest value of its group: α
    and β each, the head's scalars together."""
    head = max(float(v.abs().max()) for k, v in want.items() if k.startswith("head."))
    return {k: float((got[k].cpu() - want[k].cpu()).abs().max())
            / max(head if k.startswith("head.") else float(want[k].abs().max()), 1e-30)
            for k in want}


def fr_moments_timing(dtype: str, gen) -> dict:
    """The moments kernel at the FR step's six stage shapes (FR_BATCH pairs
    at 256²): its statistics held to its plain version's within RTOL / ATOL,
    its time and the plain version's, with its bound."""
    from nerf_qa_torch.ops.cuda import moments

    rows, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for (h, w), c in zip(STAGE_HW, STAGE_C):
        shape = (FR_BATCH, h, w, c)
        fx, fy = feature_pair(shape, getattr(torch, dtype), gen)
        err = check_close(moments.stats_from_sums(moments.moment_sums(fx, fy), h * w),
                          moments.stats_from_sums(moments.moment_sums_plain(fx, fy), h * w),
                          RTOL, ATOL, f"moments {shape} {dtype} vs plain")
        bound_ms, by = moments_bound(shape, fx.element_size())
        row = {"shape": list(shape), "max_abs_err": err,
               "ms": time_ms(lambda: moments.moment_sums(fx, fy)),
               "plain_ms": time_ms(lambda: moments.moment_sums_plain(fx, fy)),
               "bound_ms": bound_ms, "bound_by": by}
        for k in totals:
            totals[k] += row[k]
        rows.append(row)
        del fx, fy
    return dict(totals, per_stage=rows)


def fr_train_path(vgg, gen) -> None:
    """Phase fr_train_path: FRTrainer at full width (VGG16, all 1475
    channels) on a fixed batch of FR_BATCH 256² pairs made on the card, in
    both pyramid dtypes: one step's loss and gradients with the moments
    kernel against the eager statistics from identical params, the cached
    step against the image step (fp32), launches per step, cache batch and
    eval batch, a falling loss over the counted steps, image-path frames/s
    in turns (kernel, eager, eager, kernel), cache-build frames/s, cached
    epoch ms per step, peak memory, the profiler's busy and idle share and
    the step's per-range breakdown (``range_times``), and the moments
    kernel at the step's shapes."""
    dist, ref, targets = fr_batch(gen, FR_BATCH, 256)
    vids = np.arange(FR_BATCH)
    for dtype in FR_DTYPES:
        trainer = make_fr_trainer(vgg, dtype, "kernel")
        eager = make_fr_trainer(vgg, dtype, "eager")
        per_pair = trainer.compute_dists_scores([(dist, ref, targets, vids)])
        params, opt = trainer.init(np.array([per_pair[i] for i in range(FR_BATCH)]),
                                   targets.cpu().numpy())
        start = trainer.to_device(params)

        def det_loss():
            pred, _ = trainer.evaluate(params, dist, ref)
            return float((pred - targets).abs().mean())

        # the kernel against the eager statistics, one step from identical params
        k_loss, k_grads = fr_grads(trainer, start, dist, ref, targets)
        e_loss, e_grads = fr_grads(eager, start, dist, ref, targets)
        loss_gap = abs(k_loss - e_loss)
        gaps = fr_grad_gaps(k_grads, e_grads)
        worst = max(gaps, key=gaps.get)
        if not (loss_gap <= FR_PLAIN_LOSS_ATOL[dtype]
                and gaps[worst] <= FR_PLAIN_GRAD_RTOL[dtype]):
            raise AssertionError(f"FR training ({dtype}) kernel vs eager: loss gap "
                                 f"{loss_gap}, gradient {worst} {gaps[worst]}")
        cached = {}
        if dtype == "float32":
            # the cached step against the image step, from identical params
            # and fresh optimizer states
            cache = trainer.build_stats_cache([(dist, ref, targets, vids)])
            p_img, p_c = trainer.to_device(start), trainer.to_device(start)
            _, _, l_img, aux_img = trainer.train_step(
                p_img, trainer.optimizer.init(p_img), dist, ref, targets)
            _, _, l_c, aux_c = trainer.train_step_cached(
                p_c, trainer.optimizer.init(p_c), cache["stats"], cache["targets"])
            with torch.no_grad():
                head_gap = max(float((p_img["head"][k] - p_c["head"][k]).abs().max())
                               for k in p_img["head"])
                ab_gap = max(float((a - b).abs().max())
                             for a, b in zip(p_img["dists"], p_c["dists"]))
            cached = {"loss_gap": abs(float(l_img) - float(l_c)), "head_gap": head_gap,
                      "alpha_beta_gap": ab_gap,
                      "pred_gap": float((aux_img[0] - aux_c[0]).abs().max())}
            if not (cached["loss_gap"] <= FR_CACHED_LOSS_ATOL
                    and cached["pred_gap"] <= FR_CACHED_LOSS_ATOL
                    and max(head_gap, ab_gap) <= FR_CACHED_PARAM_ATOL):
                raise AssertionError(f"FR cached step vs image step: {cached}")

        loss_init = det_loss()
        trainer.train_step(params, opt, dist, ref, targets)  # warm-up
        loss_before = det_loss()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        step_losses = [float(trainer.train_step(params, opt, dist, ref, targets)[2])
                       for _ in range(FR_COUNTED)]
        counts = {"step": launch_counts()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        loss_after = det_loss()
        reset_launches()
        trainer.build_stats_cache([(dist, ref, targets, vids)])
        counts["cache_batch"] = launch_counts()
        reset_launches()
        trainer.evaluate(params, dist, ref)
        torch.cuda.synchronize()
        counts["eval_batch"] = launch_counts()
        want = {"step": {k: v * FR_COUNTED for k, v in FR_LAUNCHES.items()},
                "cache_batch": FR_LAUNCHES, "eval_batch": FR_LAUNCHES}
        if counts != want:
            raise AssertionError(f"FR training ({dtype}) launches {counts}, expected {want}")
        if not (all(math.isfinite(v) for v in step_losses)
                and math.isfinite(loss_after) and loss_after < loss_before):
            raise AssertionError(f"FR training ({dtype}) losses {step_losses}, "
                                 f"{loss_before} -> {loss_after}")

        # image-path frames/s in turns
        rates = {"kernel": [], "eager": []}
        for name, tr in (("kernel", trainer), ("eager", eager), ("eager", eager),
                         ("kernel", trainer)):
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
            for _ in range(FR_TIMED):
                tr.train_step(params, opt, dist, ref, targets)
            end_ev.record()
            end_ev.synchronize()
            rates[name].append(FR_BATCH * FR_TIMED / (start_ev.elapsed_time(end_ev) / 1e3))

        # the stats cache (host copies included) and an epoch over it
        batches = [(dist, ref, targets, vids + i * FR_BATCH) for i in range(FR_CACHE_BATCHES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = trainer.build_stats_cache(batches)
        cache_fps = FR_CACHE_BATCHES * FR_BATCH / (time.perf_counter() - t0)
        order = np.random.default_rng(0).permutation(len(cache["targets"]))
        t0 = time.perf_counter()
        params, opt, _ = trainer.train_epoch_cached(params, opt, cache, order, FR_BATCH)
        torch.cuda.synchronize()
        cached_ms = (time.perf_counter() - t0) * 1e3 / FR_CACHE_BATCHES

        prof = profile_step(lambda: trainer.train_step(params, opt, dist, ref, targets))
        if set(prof.get("layers_device_ms", ())) != set(FR_LAYERS):
            raise AssertionError(f"FR training ({dtype}) profiler ranges {prof}")
        phase("fr_train_path", compute_dtype=dtype, batch=FR_BATCH, hw=[256, 256],
              regression_type="logistic", lr=FR_LR, schedule="exp",
              steps_per_epoch=FR_STEPS_PER_EPOCH, launches=counts,
              counted_step_losses=step_losses, det_loss_init=loss_init,
              det_loss_before=loss_before, det_loss_after=loss_after,
              kernel_vs_eager_loss_gap=loss_gap,
              kernel_vs_eager_worst_grad=[worst, gaps[worst]],
              loss_atol=FR_PLAIN_LOSS_ATOL[dtype], grad_rtol=FR_PLAIN_GRAD_RTOL[dtype],
              cached_vs_image=cached, frames_per_s=rates, cache_build_frames_per_s=cache_fps,
              cached_epoch_ms_per_step=cached_ms, peak_mem_gib=peak,
              moments_at_step=fr_moments_timing(dtype, gen), **prof)
        del trainer, eager, cache
        torch.cuda.empty_cache()


def fr_train_cpu_parity(gen) -> None:
    """Phase fr_train_cpu_parity: one fp32 FR step's loss and gradients at
    64², batch 4, on the card under true fp32 (moments kernel) against the
    port's CPU path (its plain version) from the same weights: the loss
    within SCORE_ATOL, each gradient within TRAIN_CPU_GRAD_RTOL of the
    largest of its group."""
    from nerf_qa_torch.compat.pretrained import resolve_vgg_params
    from nerf_qa_torch.config import true_fp32

    dist, ref, targets = fr_batch(gen, 4, 64)
    x = np.linspace(0.01, 0.3, 8)
    y = 1.0 + 4.0 / (1.0 + np.exp((x - 0.15) / 0.04))
    out = {}
    with true_fp32():
        for name, device, args in (("card", "cuda", (dist, ref, targets)),
                                   ("cpu", "cpu", tuple(t.cpu() for t in (dist, ref, targets)))):
            trainer = make_fr_trainer(resolve_vgg_params(seed=0), "float32", "kernel",
                                      device=device)
            params, _ = trainer.init(x, y)
            reset_launches()
            loss, grads = fr_grads(trainer, params, *args)
            out[name] = (loss, grads, launch_counts())
    (kl, kg, counts), (cl, cg, cpu_counts) = out["card"], out["cpu"]
    gaps = fr_grad_gaps(kg, cg)
    worst = max(gaps, key=gaps.get)
    if counts != FR_LAUNCHES or any(cpu_counts.values()):
        raise AssertionError(f"card launches {counts}, CPU launches {cpu_counts}")
    if abs(kl - cl) > SCORE_ATOL or gaps[worst] > TRAIN_CPU_GRAD_RTOL:
        raise AssertionError(f"FR training card vs CPU: loss {kl} vs {cl}, "
                             f"gradient {worst} {gaps[worst]}")
    phase("fr_train_cpu_parity", hw=[64, 64], batch=4, loss=kl, loss_gap=abs(kl - cl),
          worst_grad=[worst, gaps[worst]], grad_rtol=TRAIN_CPU_GRAD_RTOL, launches=counts)


def fr_cli_run() -> None:
    """Phase fr_cli: on a synthetic FR tree (frames of 288 x 352, resized
    to 256² by the loaders) in a temporary directory: ``run_fr`` with two
    folds, two epochs and the stats cache, then one fold (the full-data
    train, with a validation pass) for one epoch on the image path;
    ``prep_fr`` with the square and full-size policies (DISTS and ADISTS);
    ``reeval`` of the image run's checkpoint. Each returns 0, writes its
    CSVs and launches the moments kernel; prep_fr launches the windowed T/S
    kernel too."""
    import io
    import os

    from nerf_qa_torch.tools import prep_fr, reeval, run_fr
    from nerf_qa_torch.tools.make_synthetic_dataset import make_fr_tree

    calls = {}
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        scores = make_fr_tree(data, scenes=("lego", "truck", "ship", "fortress"),
                              methods_per_scene=2, frames=4, hw=(288, 352))
        common = ["--data-dir", data, "--scores-csv", scores, "--batch-size", "8",
                  "--num-workers", "2"]
        runs = (
            ("run_fr_cached", run_fr.main,
             common + ["--folds", "2", "--epochs", "2", "--cache-stats",
                       "--output-dir", f"{tmp}/cv"],
             [f"{tmp}/cv/{f}" for f in ("results_0.csv", "results_1.csv",
                                        "results_cv.csv")]),
            ("run_fr_image", run_fr.main,
             common + ["--folds", "1", "--epochs", "1", "--val-scores-csv", scores,
                       "--val-data-dir", data, "--output-dir", f"{tmp}/img"],
             [f"{tmp}/img/results_val_1.csv"]),
            ("prep_square", prep_fr.main,
             ["--data-dir", data, "--scores-csv", scores, "--policy", "square",
              "--output-csv", f"{tmp}/square.csv"], [f"{tmp}/square.csv"]),
            ("prep_full_size", prep_fr.main,
             ["--data-dir", data, "--scores-csv", scores, "--policy", "full_size",
              "--output-csv", f"{tmp}/full.csv"], [f"{tmp}/full.csv"]),
            ("reeval", reeval.main,
             ["--checkpoint", f"{tmp}/img/ckpt", "--data-dir", data, "--scores-csv",
              scores, "--output-csv", f"{tmp}/reeval.csv"], [f"{tmp}/reeval.csv"]),
        )
        for name, fn, argv, files in runs:
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = fn(argv)
            torch.cuda.synchronize()
            missing = [f for f in files if not os.path.exists(f)]
            rows = 0
            if not missing:
                with open(files[0], newline="") as f:
                    rows = sum(1 for _ in f) - 1
            calls[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                           "launches": launch_counts(), "rows": rows,
                           "missing": [os.path.basename(f) for f in missing]}
        with open(f"{tmp}/reeval.csv", newline="") as f:
            reeval_preds = [float(r.split(",")[1]) for r in f.read().splitlines()[1:]]
    for name, call in calls.items():
        tsd = call["launches"]["windowed_tsd"]
        if not (call["rc"] == 0 and not call["missing"] and call["rows"] > 0
                and call["launches"]["moments"] > 0
                and (tsd > 0 if name.startswith("prep") else tsd == 0)):
            raise AssertionError(f"FR CLI {name}: {call}; output {text.getvalue()[-2000:]}")
    if not (len(reeval_preds) == 8 and all(math.isfinite(v) for v in reeval_preds)):
        raise AssertionError(f"reeval scores {reeval_preds}")
    phase("fr_cli", frame_hw=[288, 352], calls=calls, reeval_pred_scores=reeval_preds)


def fr_quality() -> None:
    """Phase fr_quality: ``quality_demo --kind fr`` at the JAX package's
    certificate settings (random VGG weights from the seed, 40 videos,
    4-fold scene-grouped CV through run_fr with the stats cache) for seeds
    0, 1 and 2, each held to the certificate's thresholds."""
    import io

    from nerf_qa_torch.tools import quality_demo

    results = {}
    for seed in (0, 1, 2):
        reset_launches()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            res = quality_demo.main(["--kind", "fr", "--out", tmp, *FR_QUALITY_ARGS,
                                     "--seed", str(seed)])
        results[seed] = dict(res, seconds=time.perf_counter() - t0,
                             moments_launches=launch_counts()["moments"])
        if not (res["n_videos"] == 40 and results[seed]["moments_launches"] > 0
                and all(res[k] >= v for k, v in FR_QUALITY_MIN.items())):
            raise AssertionError(f"FR quality certificate, seed {seed}: {res} "
                                 f"(thresholds {FR_QUALITY_MIN})")
    phase("fr_quality", args=" ".join(FR_QUALITY_ARGS), thresholds=FR_QUALITY_MIN,
          results=results)


# The data feed and the scoring service. The native decoder's
# parity bars are those of the JAX package's tests/test_native_decoder.py.
NATIVE_TOL = {"png": 1e-6, "resize": 1e-5, "jpeg": 2.5 / 255, "rgba": 1 / 255 + 1e-6}
DECODE_FIXTURES = 16  # distinct 1080p JPEGs of the decode rates
SERVE_BATCH = 32
SERVE_CLIENTS = 8
SERVE_FRAMES = 12  # frames of a request's 1080p video
# a client's requests, all in flight at once: three FR pairs, one NR render
SERVE_PLAN = ("fr", "fr", "fr", "nr")
SERVE_DIRECT_ATOL = 1e-5  # responses against the scorers called directly
FULL_SIZE_FRAMES = 2
FEED_MODES = ("dists_jpeg", "dists_uint8_cache", "nr_full")
FEED_FRAMES = 256


def video_u8(rng, n: int, hw=FRAME_HW, base_shift: float = 0.0) -> np.ndarray:
    """n seeded uint8 frames: a smooth gradient plus noise texture (JPEG
    entropy like rendered content), drifting across the frames."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1) * 0.7
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        noise = rng.integers(-20, 21, (h, w, 3), dtype=np.int16)
        img = (base + base_shift + 0.01 * i) * 255 + noise
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def write_video(root: Path, name: str, frames: np.ndarray, as_mp4: bool) -> str:
    """A Motion-JPEG mp4 (the port's writer), or a directory of the same
    JPEGs (PIL at the writer's quality)."""
    from PIL import Image

    from nerf_qa_torch.data.video import write_mjpeg_mp4

    root.mkdir(parents=True, exist_ok=True)
    if as_mp4:
        path = root / f"{name}.mp4"
        write_mjpeg_mp4(str(path), frames)
        return str(path)
    path = root / name
    path.mkdir(parents=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(path / f"{i:03d}.jpg", quality=90)
    return str(path)


def native_decoder() -> bool:
    """Phase native_decoder: build the port's native decoder with g++, hold
    it to the PIL route on this host (where it builds), and time 1080p
    JPEG -> 256² decodes at 1, 2, 4, 8 threads and nproc through the route
    the loaders take here (bench_host_decode). Returns whether it built."""
    from PIL import Image

    from nerf_qa_torch.data import imaging, native
    from nerf_qa_torch.tools import bench_host_decode as bhd

    t0 = time.perf_counter()
    built = native.available()
    fields = {"built": built, "build_seconds": time.perf_counter() - t0,
              "nproc": os.cpu_count()}
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        if built:
            errs = {}
            png, jpg, rgba = (f"{tmp}/a.png", f"{tmp}/a.jpg", f"{tmp}/rgba.png")
            Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(png)
            Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
                jpg, quality=95)
            arr = np.zeros((8, 8, 4), np.uint8)
            arr[..., 0], arr[..., 3] = 200, 128
            Image.fromarray(arr, "RGBA").save(rgba)
            for key, got, want in (
                    ("png", native.decode_resize(png, 48, 64), imaging.load_image_rgb(png)),
                    ("resize", native.decode_resize(png, 32, 32),
                     imaging.resize_image(imaging.load_image_rgb(png), 32, 32)),
                    ("jpeg", native.decode_resize(jpg, 40, 56), imaging.load_image_rgb(jpg)),
                    ("rgba", native.decode_resize(rgba, 8, 8), imaging.load_image_rgb(rgba))):
                errs[key] = float(np.abs(got - want).max())
                if errs[key] > NATIVE_TOL[key]:
                    raise AssertionError(f"native decoder {key}: {errs[key]} > "
                                         f"{NATIVE_TOL[key]}")
            fields["max_abs_err_vs_pil"] = errs
        else:
            fields["reason"] = (native.unavailable_reason() or "")[-800:]
        paths = bhd.make_fixtures(tmp, DECODE_FIXTURES)
        threads = sorted({1, 2, 4, 8, os.cpu_count() or 1})
        fields["decoder"] = "native" if built else "pil"
        fields["fps_1080p_jpeg_to_256"] = {
            t: bhd.bench_decode(paths, t, reps=2) for t in threads}
        if built:
            fields["fps_1080p_jpeg_to_256_fast"] = {
                t: bhd.bench_decode(paths, t, reps=2, fast=True) for t in threads}
    phase("native_decoder", **fields)
    return built


def mp4_path(built: bool) -> None:
    """Phase mp4_path: 1080p MJPEG mp4 pairs (24 frames, seeded) written by
    the port, scored by ``score.main(--metric both)``, against the same
    JPEG samples as frame directories (bit-equal: one decoder, one shape),
    with the moments and T/S kernels launched and no PIL fallback. Runs
    only where the native decoder builds."""
    import io

    from nerf_qa_torch.data import imaging, native
    from nerf_qa_torch.tools import score

    if not built:
        phase("mp4_path", ran=False,
              reason=f"native decoder not built: {native.unavailable_reason()}"[:800])
        return
    rng = np.random.default_rng(9)
    ref = video_u8(rng, 24)
    dist = np.clip(ref.astype(np.int16) + rng.integers(-12, 13, ref.shape), 0,
                   255).astype(np.uint8)
    fallbacks = imaging.pil_fallbacks
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        inputs = {as_mp4: [write_video(root / str(as_mp4), n, f, as_mp4)
                           for n, f in (("ref", ref), ("dist", dist))]
                  for as_mp4 in (True, False)}
        results, csvs, counts = {}, {}, {}
        for as_mp4, (r, d) in inputs.items():
            csv = root / f"scores_{as_mp4}.csv"
            reset_launches()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = score.main(["--ref", r, "--dist", d, "--metric", "both", "--json",
                                 "--out-csv", str(csv)])
            counts[as_mp4] = launch_counts()
            if rc != 0:
                raise AssertionError(f"score on {'mp4' if as_mp4 else 'dirs'}: rc {rc}")
            results[as_mp4] = json.loads(out.getvalue().strip().splitlines()[-1])
            csvs[as_mp4] = csv.read_text()
    ok = (csvs[True] == csvs[False] and results[True] == results[False]
          and counts[True]["moments"] > 0 and counts[True]["windowed_tsd"] > 0
          and imaging.pil_fallbacks == fallbacks
          and all(math.isfinite(v["video_score"]) for v in results[True].values()))
    phase("mp4_path", ran=True, frame_hw=list(FRAME_HW), frames=24, result=results[True],
          frame_dirs_result=results[False], per_frame_equal=csvs[True] == csvs[False],
          launches=counts[True], pil_fallbacks=imaging.pil_fallbacks - fallbacks)
    if not ok:
        raise AssertionError(f"mp4 path: {results}, launches {counts}")


def nr_pth(path: Path) -> str:
    """A reference-layout NR v8 .pth: a seeded decoder at full width."""
    from nerf_qa_torch.config import NRModelConfig
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.layers import init_lecun_normal_

    decoder = init_lecun_normal_(NRDecoder(NRModelConfig()),
                                 torch.Generator().manual_seed(3))
    torch.save(dict(decoder.state_dict()), path)
    return str(path)


def _post(port: int, payload: dict, timeout: float = 600) -> tuple[dict, float]:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/score", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        resp = json.loads(r.read())
    return resp, time.perf_counter() - t0


def _gap(got: list[float], want: np.ndarray) -> float:
    return float(np.abs(np.asarray(got, np.float32) - want).max())


def _recording_step(step, record: list, *batch):
    """A batcher's step that keeps its batch and host scores in
    ``record``."""
    from nerf_qa_torch.tools.serve import _host

    out = _host(step(*batch))
    record.append((batch, out))
    return out


def _frame_key(rows) -> bytes:
    """One frame's identity across a path's inputs (a digest of its rows)."""
    import hashlib

    h = hashlib.sha1()
    for r in rows:
        h.update(np.ascontiguousarray(r).tobytes())
    return h.digest()


def _scores_by_frame(record: list) -> dict[bytes, set]:
    """Every score a path's steps gave each distinct input frame."""
    out: dict[bytes, set] = {}
    for batch, scores in record:
        for i, v in enumerate(scores):
            out.setdefault(_frame_key(b[i] for b in batch), set()).add(np.float32(v))
    return out


def serve_path(model, built: bool) -> None:
    """Phase serve_path: the scoring service at full width on the card.

    An in-process ``ScoringService`` (--metric both, batch 32, bf16, the
    bundled α/β, the seeded VGG, an NR v8 .pth from a seeded full-width
    decoder with ViT-S/14 depth 12) warmed up at 256², behind its HTTP
    server on a free port; 8 clients each post three FR requests of a
    12-frame 1080p pair and one NR request, all 32 in flight at once
    (mp4s where the native decoder builds, JPEG frame directories
    otherwise). The batches each path stepped are recorded and replayed
    through the scorers called directly (the same decoded frames at the
    same batch size and positions), and every response's frames must be
    among those outputs; the moments, T/S, JBU and ChannelNorm forward
    kernels' launches are held to their per-step counts times the steps.
    Then a profiled
    window of concurrent requests, the host decode share of a lone FR
    request, and one --full-size request of a 1080p pair, cold and warm."""
    import threading

    from nerf_qa_torch.compat.pretrained import resolve_dists_weights
    from nerf_qa_torch.config import ADISTSConfig, DISTSConfig
    from nerf_qa_torch.data import imaging
    from nerf_qa_torch.eval.video_scorer import batched_map
    from nerf_qa_torch.tools import score, serve

    rng = np.random.default_rng(11)
    weights = resolve_dists_weights(DISTSConfig())
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pairs = []
        for k in range(2):
            ref = video_u8(rng, SERVE_FRAMES, base_shift=0.05 * k)
            dist = np.clip(ref.astype(np.int16) + rng.integers(-15, 16, ref.shape),
                           0, 255).astype(np.uint8)
            pairs.append((write_video(root, f"ref{k}", ref, built),
                          write_video(root, f"dist{k}", dist, built)))
        args = serve.build_parser().parse_args(
            ["--http", "0", "--metric", "both", "--batch-size", str(SERVE_BATCH),
             "--nr-ckpt", nr_pth(root / "nr.pth")])
        svc = serve.ScoringService(args, model, weights)
        t0 = time.perf_counter()
        svc.warmup((256, 256))
        warmup_s = time.perf_counter() - t0
        server = serve.make_http_server(svc, 0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            plan = [[(kind, (i + j) % 2) for j, kind in enumerate(SERVE_PLAN)]
                    for i in range(SERVE_CLIENTS)]
            responses, errors = [], []
            lock = threading.Lock()
            # every client has its four requests in flight at once: all
            # 32 start together
            start = threading.Barrier(SERVE_CLIENTS * len(SERVE_PLAN), timeout=600)

            def request(i, kind, k):
                try:
                    req = {"id": f"{i}-{kind}-{k}", "dist": pairs[k][1]}
                    if kind == "fr":
                        req["ref"] = pairs[k][0]
                    start.wait()
                    resp, secs = _post(port, req)
                    with lock:
                        responses.append((kind, k, resp, secs))
                except Exception as e:  # reported below
                    errors.append(repr(e))

            # every batch a path steps, with its output, for the replay below
            recorded = {name: [] for name in svc.batchers}
            step_fns = {name: b.step_fn for name, b in svc.batchers.items()}
            for name, b in svc.batchers.items():
                b.step_fn = functools.partial(_recording_step, step_fns[name],
                                              recorded[name])
            reset_launches()
            fallbacks = imaging.pil_fallbacks
            threads = [threading.Thread(target=request, args=(i, kind, k))
                       for i in range(SERVE_CLIENTS) for kind, k in plan[i]]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            load_s = time.perf_counter() - t0
            counts = launch_counts()
            stats = svc.stats()
            steps = {k: b.device_steps for k, b in svc.batchers.items()}
            for name, b in svc.batchers.items():
                b.step_fn = step_fns[name]
            if errors or any("error" in r for _, _, r, _ in responses):
                raise AssertionError(f"serve_path: {errors} "
                                     f"{[r for _, _, r, _ in responses if 'error' in r]}")
            n_req = len(responses)
            expect = {"moments": 6 * (steps["dists"] + steps["nr"]),
                      "windowed_tsd": 5 * steps["adists"],
                      "jbu": 4 * steps["nr"], "channelnorm": NR_CN_PER_BATCH * steps["nr"]}
            if any(counts[k] != v or v == 0 for k, v in expect.items()):
                raise AssertionError(f"serve_path launches {counts}, expected {expect} "
                                     f"for steps {steps}")

            # The scorers called directly on the batches the service stepped
            # (the same decoded frames at the same batch size and positions):
            # a frame's score moves with its position in the batch (cuDNN's
            # last-stage convolution rounds a bf16 feature differently at
            # another position of the batch on an H100), not with the other
            # frames. Each response's frames must be among those outputs.
            acfg = ADISTSConfig(compute_dtype="bfloat16")
            direct = {"dists": svc.scorer.score_batch,
                      "adists": lambda a, b: score.adists_batch(model, a, b, acfg),
                      "nr": svc.nr_scorer.step_batch}
            gaps = {m: max(_gap(out, serve._host(direct[m](*batch)))
                           for batch, out in recorded[m]) for m in recorded}
            outputs = {m: _scores_by_frame(recorded[m]) for m in recorded}
            # the responses' frames keyed as the batchers saw them; and, for
            # the record, the direct scorers with each request's frames at
            # the batch's first positions (batched_map's padding)
            unmatched, own_position_gaps = [], {m: 0.0 for m in recorded}
            for k, (r, d) in enumerate(pairs):
                ref_f = score._load_frames(r, True, False)
                dist_f = score._load_frames(d, True, False)
                nr_in = svc.nr_scorer.prep_frames(score._load_frames(d, False, False))
                inputs = {"dists": (dist_f, ref_f), "adists": (dist_f, ref_f), "nr": nr_in}
                want = {
                    "dists": svc.scorer.score_frames(dist_f, ref_f, SERVE_BATCH),
                    "adists": batched_map(
                        lambda a, b: score.adists_batch(model, a, b, acfg).cpu().numpy(),
                        (dist_f, ref_f), SERVE_BATCH),
                    "nr": batched_map(lambda a, b: svc.nr_scorer.step_batch(a, b).cpu().numpy(),
                                      nr_in, SERVE_BATCH),
                }
                for kind, kk, resp, _ in responses:
                    if kk != k:
                        continue
                    for m in (("dists", "adists") if kind == "fr" else ("nr",)):
                        own_position_gaps[m] = max(own_position_gaps[m],
                                                   _gap(resp[f"{m}_frames"], want[m]))
                        for i, v in enumerate(resp[f"{m}_frames"]):
                            key = _frame_key(a[i] for a in inputs[m])
                            if np.float32(v) not in outputs[m].get(key, ()):
                                unmatched.append((resp["id"], m, i))
            if max(gaps.values()) > SERVE_DIRECT_ATOL or unmatched:
                raise AssertionError(f"serve_path vs direct scorers: {gaps}, response "
                                     f"frames not among the steps' outputs: {unmatched[:8]}")
            if imaging.pil_fallbacks != fallbacks:
                raise AssertionError("serve_path took PIL fallbacks")

            # a steady window of concurrent FR requests under the profiler
            def window():
                ts = [threading.Thread(target=svc.handle, args=(
                    {"id": i, "dist": pairs[i % 2][1], "ref": pairs[i % 2][0]},))
                    for i in range(4)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()

            prof = profile_step(window)
            # the host decode share of a lone FR request
            t0 = time.perf_counter()
            score._load_frames(pairs[0][1], True, False)
            score._load_frames(pairs[0][0], True, False)
            decode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            svc.handle({"id": "lone", "dist": pairs[0][1], "ref": pairs[0][0]})
            lone_s = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
        fr_lat = sorted(s for kind, _, _, s in responses if kind == "fr")
        nr_lat = sorted(s for kind, _, _, s in responses if kind == "nr")
        frames = sum(r["frames"] for _, _, r, _ in responses)
        phase("serve_path", batch=SERVE_BATCH, clients=SERVE_CLIENTS,
              frames_per_request=SERVE_FRAMES, frame_hw=list(FRAME_HW),
              inputs="mp4" if built else "jpeg_frame_dirs", requests=n_req,
              warmup_s=warmup_s, load_s=load_s, requests_per_s=n_req / load_s,
              frames_per_s=frames / load_s, stats=stats, device_steps=steps,
              launches=counts, launches_expected=expect,
              client_latency_s={"fr_min": fr_lat[0], "fr_p50": fr_lat[len(fr_lat) // 2],
                                "fr_max": fr_lat[-1], "nr_min": nr_lat[0],
                                "nr_p50": nr_lat[len(nr_lat) // 2], "nr_max": nr_lat[-1]},
              max_gap_vs_direct_on_stepped_batches=gaps,
              max_gap_vs_direct_at_own_positions=own_position_gaps,
              pil_fallbacks=imaging.pil_fallbacks - fallbacks,
              lone_fr_request_s=lone_s, lone_fr_decode_s=decode_s,
              host_decode_share=decode_s / lone_s, window=prof)
        if not stats["device_steps"] < n_req == stats["requests"]:
            raise AssertionError(f"serve_path: no coalescing: {stats}")

        # --full-size: DISTS (moments) and ADISTS (T/S) at 1080p, one new
        # shape bucket: the first request is cold, the second warm
        ref = video_u8(rng, FULL_SIZE_FRAMES)
        dist = np.clip(ref.astype(np.int16) + 10, 0, 255).astype(np.uint8)
        req = {"id": "full", "ref": write_video(root, "full_ref", ref, built),
               "dist": write_video(root, "full_dist", dist, built)}
        full = serve.ScoringService(serve.build_parser().parse_args(
            ["--stdio", "--full-size", "--metric", "both", "--batch-size",
             str(FULL_SIZE_FRAMES)]), model, weights)
        try:
            reset_launches()
            t0 = time.perf_counter()
            cold = full.handle(req)
            cold_s = time.perf_counter() - t0
            cold_counts = launch_counts()
            t0 = time.perf_counter()
            warm = full.handle(req)
            warm_s = time.perf_counter() - t0
        finally:
            full.close()
    if "error" in cold or "error" in warm:
        raise AssertionError(f"serve --full-size: {cold} / {warm}")
    repeat_gap = max(_gap(warm[f"{m}_frames"], np.asarray(cold[f"{m}_frames"], np.float32))
                     for m in ("dists", "adists"))
    ok = (repeat_gap <= SERVE_DIRECT_ATOL and cold_counts["moments"] == 6
          and cold_counts["windowed_tsd"] == len(tsd_shapes(1, *FRAME_HW))
          and all(math.isfinite(v) for v in cold["dists_frames"] + cold["adists_frames"]))
    phase("serve_full_size", frame_hw=list(FRAME_HW), frames=FULL_SIZE_FRAMES,
          cold_s=cold_s, warm_s=warm_s, launches=cold_counts, response=cold,
          warm_vs_cold_gap=repeat_gap)
    if not ok:
        raise AssertionError(f"serve --full-size: {cold} / {warm}, launches {cold_counts}")


def serve_cli(model) -> None:
    """Phase serve_cli: ``python3 -m nerf_qa_torch.tools.serve --stdio
    --metric dists --no-warmup`` as a subprocess on two requests, on its
    default device (the card): its scores equal the card's FrameScorer on
    the same frames."""
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.eval.video_scorer import FrameScorer
    from nerf_qa_torch.tools import score

    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        reqs = []
        for k in range(2):
            ref = video_u8(rng, 2, (96, 128))
            dist = np.clip(ref.astype(np.int16) + 8 * (k + 1), 0, 255).astype(np.uint8)
            reqs.append({"id": k, "ref": write_video(root, f"r{k}", ref, False),
                         "dist": write_video(root, f"d{k}", dist, False)})
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nerf_qa_torch.tools.serve", "--stdio", "--metric",
             "dists", "--no-warmup"],
            input="".join(json.dumps(r) + "\n" for r in reqs), capture_output=True,
            text=True, timeout=600, cwd=Path(__file__).resolve().parent)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"serve CLI rc {proc.returncode}: {proc.stderr[-2000:]}")
        resp = [json.loads(line) for line in proc.stdout.splitlines()]
        cfg = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
        scorer = FrameScorer(model, resolve_dists_weights(DISTSConfig()), cfg,
                             resize_to=None)
        gaps = [_gap(r["dists_frames"], scorer.score_frames(
            score._load_frames(q["dist"], True, False),
            score._load_frames(q["ref"], True, False), 32)) for r, q in zip(resp, reqs)]
    ok = (len(resp) == 2 and all("error" not in r and r["frames"] == 2 for r in resp)
          and max(gaps) <= SERVE_DIRECT_ATOL)
    phase("serve_cli", argv="--stdio --metric dists --no-warmup", seconds=secs,
          responses=resp, max_gap_vs_card_scorer=max(gaps) if gaps else None)
    if not ok:
        raise AssertionError(f"serve CLI: {resp} {gaps} {proc.stderr[-2000:]}")


def feed(model) -> None:
    """Phase feed: bench_feed's dists_jpeg, dists_uint8_cache and nr_full
    modes (sustained frames/s, host decode feeding the card), each beside
    the device rate of the same step on inputs already on the card."""
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights, resolve_vit_params
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig
    from nerf_qa_torch.eval.video_scorer import FrameScorer
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.tools import bench_feed

    t0 = time.perf_counter()
    res = bench_feed.run(frames=FEED_FRAMES, n_pairs=16, batch=16, modes=FEED_MODES)
    feed_s = time.perf_counter() - t0
    cfg = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
    scorer = FrameScorer(model, resolve_dists_weights(cfg), cfg, resize_to=None)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand((16, 256, 256, 3), generator=gen, device="cuda")
    u8 = (x * 255).to(torch.uint8)
    device_fps = {
        "dists_jpeg": 16 / time_ms(lambda: scorer.score_batch(x, x.flip(0))) * 1e3,
        "dists_uint8_cache": 16 / time_ms(lambda: scorer.score_batch(u8, u8.flip(0))) * 1e3,
    }
    ncfg = NRModelConfig(transformer_decoder_depth=2, refine_up_depth=2, dropout_rate=0.2,
                         decoder_dtype="bfloat16", dists=cfg)
    nr = NRModel(model, cfg=ncfg, seed=0, vit=resolve_vit_params(depth=12)).to("cuda").eval()
    r224 = torch.rand((8, 224, 224, 3), generator=gen, device="cuda")
    with torch.no_grad():
        device_fps["nr_full"] = 8 / time_ms(lambda: nr(x[:8], r224), iters=10) * 1e3
    missing = [m for m in FEED_MODES if not res.get(f"fps_{m}", 0) > 0]
    phase("feed", seconds=feed_s, result=res, device_fps=device_fps,
          feed_share_of_device_rate={m: res[f"fps_{m}"] / device_fps[m]
                                     for m in FEED_MODES if m not in missing})
    if missing:
        raise AssertionError(f"feed: no rate for {missing}: {res}")


# The comparison and readiness tools: the classical IQA metrics (eval/iqa.py)
# at prep_fr's sizes, prep_fr --iqa, the results tables, golden_check,
# retrieval with pseudo-FR scoring, verify_assets and the sweep driver.
IQA_METRICS = ("psnr", "ssim", "ms-ssim", "lpips", "st-lpips", "gmsd", "vif", "fsim",
               "fsimc", "nlpd", "mad")
IQA_COLUMNS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS", "ST-LPIPS", "GMSD", "VIF", "FSIM",
               "FSIMc", "NLPD", "MAD")
# prep_fr's batches: the CLI default (batch 8 at 256²) and --policy
# full_size (two 1080p pairs)
IQA_SIZES = (("256", 8, 256, 256), ("1080p", 2, *FRAME_HW))
IQA_TIMED = 3  # calls a turn, two turns a metric
# the CPU tests' bars (tests/test_torch_iqa.py): fp32, MAD's detection index
# ill-conditioned in fp32
IQA_RTOL, IQA_ATOL, IQA_MAD_RTOL = 1e-4, 1e-5, 1e-3
IQA_IS_ONE = ("ssim", "ms-ssim", "vif", "fsim", "fsimc")
IQA_IS_ZERO = ("lpips", "st-lpips", "gmsd", "nlpd", "mad")
PREP_IQA_VIDEOS = 8  # eight videos of eight frames: one prep batch each
GOLDEN_ATOL = 1e-4
RETRIEVAL_INDEX = 64
RETRIEVAL_GRID_ATOL = 1e-3  # pixels (tests/test_torch_retrieval.py)
SWEEP_TRIALS = 3


def iqa_fns(vgg) -> dict:
    """Each metric as prep_fr calls it, (render, ref) in, one score per
    image out (VIF and MAD are swapped there; here both take x, y)."""
    from nerf_qa_torch.eval import iqa

    return {"psnr": iqa.psnr, "ssim": iqa.ssim, "ms-ssim": iqa.ms_ssim,
            "lpips": lambda a, b: iqa.lpips(vgg, a, b),
            "st-lpips": lambda a, b: iqa.st_lpips(vgg, a, b), "gmsd": iqa.gmsd,
            "vif": iqa.vif, "fsim": iqa.fsim, "fsimc": iqa.fsimc,
            "nlpd": lambda a, b: iqa.nlpd(a, b, levels=iqa.nlpd_max_levels(*a.shape[1:3])),
            "mad": iqa.mad}


def textured_pairs(n: int, h: int, w: int, gen, shift=(0, 0)):
    """(x, y): n textured NHWC fp32 images in [0, 1] on the generator's
    device (each its own frequencies, lightly noisy) and noisy copies;
    ``shift`` offsets the pattern by (rows, columns)."""
    dev = gen.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None, None] + shift[0]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :, None] + shift[1]
    f = 4.0 + 24.0 * torch.rand((n, 1, 1, 3), generator=gen, device=dev)
    x = 0.5 + 0.4 * torch.sin(xx / f) * torch.cos(yy / (f + 3.0))
    x = (x + 0.02 * torch.randn(x.shape, generator=gen, device=dev)).clamp(0, 1)
    y = (x + 0.05 * torch.randn(x.shape, generator=gen, device=dev)).clamp(0, 1)
    return x, y


def iqa_metrics(model) -> None:
    """Phase iqa_metrics: the eleven metrics on the card in true fp32 at
    prep_fr's two sizes: identities on identical pairs, ms a batch in two
    turns (CUDA events) and frames/s; then phase iqa_cpu_parity: the card
    against the port's CPU path on a reduced seeded pair (176 x 184, the
    least side MS-SSIM's five scales take) at the CPU tests' bars."""
    from nerf_qa_torch.compat.pretrained import resolve_vgg_params

    fns = iqa_fns(model)
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.no_grad():
        for label, n, h, w in IQA_SIZES:
            x, y = textured_pairs(n, h, w, gen)
            identity, values = {}, {}
            for name in IQA_METRICS:
                same = fns[name](x, x).float()
                identity[name] = same.tolist()
                if name == "psnr":
                    ok = bool((same > 100).all())
                elif name in IQA_IS_ONE:
                    ok = bool(((same - 1).abs() <= 1e-5).all())
                else:
                    ok = bool((same.abs() <= 1e-5).all())
                got = fns[name](x, y).float()
                values[name] = got.tolist()
                if not (ok and got.shape == (n,) and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"{name} at {label}: identical pairs {identity[name]}, "
                                         f"scores {values[name]}")
            ms = {name: [] for name in IQA_METRICS}
            for _ in range(2):  # turns: every metric once, then again
                for name in IQA_METRICS:
                    ms[name].append(time_ms(lambda: fns[name](x, y), iters=IQA_TIMED))
            phase("iqa_metrics", size=label, batch=n, hw=[h, w], dtype="float32",
                  identity=identity, scores=values, ms=ms,
                  frames_per_s={k: [n / t * 1e3 for t in v] for k, v in ms.items()},
                  batch_ms_all_metrics=[sum(v[i] for v in ms.values()) for i in range(2)])
            del x, y
        cpu_fns = iqa_fns(resolve_vgg_params(seed=0).eval())
        xc, yc = textured_pairs(2, 176, 184, torch.Generator().manual_seed(22))
        gaps = {}
        for name in IQA_METRICS:
            want = cpu_fns[name](xc, yc)
            got = fns[name](xc.cuda(), yc.cuda()).cpu()
            rtol = IQA_MAD_RTOL if name == "mad" else IQA_RTOL
            gaps[name] = check_max(got, want, rtol, IQA_ATOL, f"{name} card vs CPU")
    phase("iqa_cpu_parity", hw=[176, 184], batch=2, rtol=IQA_RTOL, atol=IQA_ATOL,
          mad_rtol=IQA_MAD_RTOL, max_abs_gap=gaps)


def _read_csv(path) -> list[dict]:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def prep_fr_iqa(tmp: str) -> str:
    """Phase prep_fr_iqa: ``tools/prep_fr --iqa`` with all eleven metrics,
    DISTS and ADISTS (the CLI's defaults: square policy, batch 8, bf16
    pyramid; the metrics in true fp32) on a synthetic Test2 tree of eight
    videos of eight 288 x 352 frames. Every column is present and finite,
    the moments and T/S kernels launch 6 and 5 times a batch, and the wall
    time a video is timed with and without the IQA columns in turns
    (without, with, with, without) after an untimed run with them. Returns
    the CSV."""
    import io

    from nerf_qa_torch.tools import prep_fr
    from nerf_qa_torch.tools.make_synthetic_dataset import make_fr_tree

    data = f"{tmp}/prep_data"
    scores = make_fr_tree(data, scenes=("lego", "ship", "truck", "room"),
                          methods_per_scene=2, frames=8, hw=(288, 352), seed=3,
                          dists_col=False)
    text = io.StringIO()
    seconds = {"with_iqa": [], "without_iqa": []}
    counts = None
    for turn, with_iqa in enumerate((True, False, True, True, False)):
        out = f"{tmp}/prep_{turn}.csv"
        argv = ["--data-dir", data, "--scores-csv", scores, "--output-csv", out]
        if with_iqa:
            argv += ["--iqa", ",".join(IQA_METRICS)]
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = prep_fr.main(argv)
        torch.cuda.synchronize()
        if turn:
            seconds["with_iqa" if with_iqa else "without_iqa"].append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"prep_fr rc {rc}: {text.getvalue()[-2000:]}")
        if with_iqa and counts is None:
            counts, csv_path = launch_counts(), out
    rows = _read_csv(csv_path)
    batches = PREP_IQA_VIDEOS  # one batch of eight frames a video
    bad = [f"{m}{s}" for m in ("DISTS", "ADISTS", *IQA_COLUMNS)
           for s in ("", "_std", "_min", "_max")
           if any(not math.isfinite(float(r.get(f"{m}{s}", "nan"))) for r in rows)]
    if len(rows) != PREP_IQA_VIDEOS or bad or counts["moments"] != 6 * batches \
            or counts["windowed_tsd"] != 5 * batches:
        raise AssertionError(f"prep_fr --iqa: {len(rows)} rows, non-finite {bad}, "
                             f"launches {counts}")
    per_video = {k: [s / PREP_IQA_VIDEOS for s in v] for k, v in seconds.items()}
    with_s, without_s = (statistics.mean(v) for v in per_video.values())
    phase("prep_fr_iqa", videos=PREP_IQA_VIDEOS, frames=8, frame_hw=[288, 352],
          policy="square", iqa=list(IQA_COLUMNS), launches=counts,
          seconds_per_video=per_video, iqa_share_of_wall_time=1.0 - without_s / with_s)
    return csv_path


def results_tables(tmp: str, csv_path: str) -> None:
    """Phase results_tables: ``tools/plot_results`` on prep_fr_iqa's CSV
    (no --figures): every metric column has finite correlations over the
    eight videos, and the LaTeX table is written."""
    import io
    import os

    from nerf_qa_torch.tools import plot_results

    out = f"{tmp}/analysis"
    cols = ["DISTS", "ADISTS", *IQA_COLUMNS]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = plot_results.main(["--results-csv", csv_path, "--metric-cols", *cols,
                                "--output-dir", out])
    table = {r["metric"]: r for r in _read_csv(f"{out}/correlations.csv")}
    corr = {m: {k: float(table[m][f"combined_{k}"]) for k in ("plcc", "srcc", "ktcc")}
            for m in cols if m in table}
    tex = os.path.getsize(f"{out}/results_table.tex") if os.path.exists(
        f"{out}/results_table.tex") else 0
    if rc != 0 or set(corr) != set(cols) or tex == 0 or not all(
            math.isfinite(v) for c in corr.values() for v in c.values()):
        raise AssertionError(f"plot_results rc {rc}: {corr}, results_table.tex {tex} B")
    phase("results_tables", metrics=cols, combined=corr, results_table_tex_bytes=tex)


def golden_phase(tmp: str) -> None:
    """Phase golden_check: ``compute_pair_score`` of two seeded 384 x 512
    PNGs (PIL's bilinear resize to 256²) on the card, 6 moments launches,
    against the port's CPU path (fp32, eager statistics); then the CLI with
    --expect set to the CPU score exits 0."""
    import io

    from PIL import Image

    from nerf_qa_torch.tools import golden_check

    x, y = textured_pairs(1, 384, 512, torch.Generator().manual_seed(23))
    paths = []
    for name, img in (("r0.png", x), ("r1.png", y)):
        paths.append(f"{tmp}/{name}")
        Image.fromarray((img[0].numpy() * 255).round().astype(np.uint8)).save(paths[-1])
    reset_launches()
    card = golden_check.compute_pair_score(*paths)
    counts = launch_counts()
    cpu = golden_check.compute_pair_score(*paths, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = golden_check.main(["--ref", paths[0], "--dist", paths[1], "--expect", repr(cpu)])
    gap = abs(card - cpu)
    if counts["moments"] != 6 or gap > GOLDEN_ATOL or rc != 0:
        raise AssertionError(f"golden_check: card {card}, CPU {cpu}, launches {counts}, "
                             f"CLI rc {rc}: {text.getvalue()}")
    phase("golden_check", card_score=card, cpu_score=cpu, card_vs_cpu_gap=gap,
          atol=GOLDEN_ATOL, launches=counts, cli_rc=rc)


def retrieval_phase(model) -> None:
    """Phase retrieval: an index of 64 seeded 256² images on the card (bf16
    descriptors, the class's default), each image retrieving itself first;
    ``pseudo_fr_score`` (bf16 matcher, fp32 DISTS) of eight shifted 256²
    pairs, frames/s in two turns, equal to its chain of parts; and the
    fp32 parts, card against the port's CPU path: the matcher's grid and
    certainty, and the certainty-masked DISTS."""
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights, resolve_vgg_params
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.eval import retrieval

    gen = torch.Generator().manual_seed(24)
    # each image its own texture and colour cast
    tint = 0.6 * torch.rand((RETRIEVAL_INDEX, 1, 1, 3), generator=gen) - 0.3
    corpus = (textured_pairs(RETRIEVAL_INDEX, 256, 256, gen)[1] + tint).clamp(0, 1).numpy()
    index = retrieval.ImageRetrieval(model)
    t0 = time.perf_counter()
    index.build_index(corpus, batch_size=16)
    # queries in the index's batches: a bf16 image's features move with its
    # position in a cuDNN batch (PERF.md §6)
    found = [index.retrieve(corpus[lo:lo + 16], k=1) for lo in range(0, RETRIEVAL_INDEX, 16)]
    top, sims = (np.concatenate(a) for a in zip(*found))
    index_s = time.perf_counter() - t0
    if not (top[:, 0] == np.arange(RETRIEVAL_INDEX)).all():
        raise AssertionError(f"retrieval: top-1 {top[:, 0].tolist()}")

    cfg = DISTSConfig()
    w = resolve_dists_weights(cfg).to("cuda")
    ref = textured_pairs(8, 256, 256, torch.Generator().manual_seed(25))[0].cuda()
    render = textured_pairs(8, 256, 256, torch.Generator().manual_seed(25),
                            shift=(3, 5))[0].cuda()
    with torch.no_grad():
        score = retrieval.pseudo_fr_score(model, w, render, ref, cfg)
        grid, cert = retrieval.estimate_warp(model, render, ref)
        chain = retrieval.masked_dists_score(model, w, render,
                                             retrieval.warp_image(ref, grid), cert, cfg)
        ms = [time_ms(lambda: retrieval.pseudo_fr_score(model, w, render, ref, cfg), iters=5)
              for _ in range(2)]
        if not bool(torch.isfinite(score).all()):
            raise AssertionError(f"pseudo_fr_score {score.tolist()}")
        chain_gap = check_max(score, chain, 0.0, SCORE_ATOL, "pseudo_fr_score vs its parts")
        cpu_vgg = resolve_vgg_params(seed=0).eval()
        r2, d2 = ref[:2].cpu(), render[:2].cpu()
        cg, cc = retrieval.estimate_warp(cpu_vgg, d2, r2, compute_dtype=torch.float32)
        kg, kc = retrieval.estimate_warp(model, d2.cuda(), r2.cuda(),
                                         compute_dtype=torch.float32)
        grid_gap = check_max(kg.cpu(), cg, 0.0, RETRIEVAL_GRID_ATOL, "matcher grid card vs CPU")
        cert_gap = check_max(kc.cpu(), cc, IQA_RTOL, IQA_ATOL, "certainty card vs CPU")
        warped = retrieval.warp_image(r2, cg)
        want = retrieval.masked_dists_score(cpu_vgg, w.to("cpu"), d2, warped, cc, cfg)
        got = retrieval.masked_dists_score(model, w, d2.cuda(), warped.cuda(), cc.cuda(), cfg)
        score_gap = check_max(got.cpu(), want, IQA_RTOL, IQA_ATOL, "masked DISTS card vs CPU")
    phase("retrieval", index=RETRIEVAL_INDEX, hw=[256, 256], index_and_retrieve_s=index_s,
          top1_self=True, self_similarity_min=float(sims.min()),
          pseudo_fr_scores=score.tolist(), chain_gap=chain_gap, pseudo_fr_ms_batch8=ms,
          pseudo_fr_frames_per_s=[8 / t * 1e3 for t in ms],
          fp32_card_vs_cpu={"grid_px": grid_gap, "certainty": cert_gap,
                            "masked_dists": score_gap})


def seeded_assets(root: str) -> None:
    """Seeded checkpoints in the reference torch layouts (as the JAX
    package's tests/test_verify_assets.py builds them): torchvision VGG16
    ``features``, ``weights.pt``, an FR ``model.pth`` (linear head, α/β,
    the VGG stages under ``dists_model.``), a DINOv2 ViT-S/14 (with its
    CLS position), a FeatUp upsampler and a v8 NR decoder at depths 2 / 2."""
    from nerf_qa_torch.compat.pretrained import resolve_vgg_params
    from nerf_qa_torch.config import NRModelConfig
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.featup import JBUStack
    from nerf_qa_torch.models.nr.layers import init_lecun_normal_
    from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_

    stages = {k: v for k, v in resolve_vgg_params(seed=0).state_dict().items()
              if k.startswith("stage") and not k.endswith("filter")}
    torch.save({f"features.{k.split('.', 1)[1]}": v for k, v in stages.items()},
               f"{root}/vgg16-397923af.pth")
    w = dists.load_pretrained_weights()
    ab = {"alpha": w.alpha.reshape(1, -1, 1, 1), "beta": w.beta.reshape(1, -1, 1, 1)}
    torch.save(ab, f"{root}/weights.pt")
    torch.save({"dists_weight": torch.tensor([-6.0]), "dists_bias": torch.tensor([5.0]),
                **{f"dists_model.{k}": v for k, v in {**ab, **stages}.items()}},
               f"{root}/model.pth")
    vit = init_vit_(ViTS14(depth=12), torch.Generator().manual_seed(4)).state_dict()
    vit["pos_embed"] = torch.cat([torch.zeros(1, 1, vit["pos_embed"].shape[-1]),
                                  vit["pos_embed"]], dim=1)
    torch.save(vit, f"{root}/dinov2_vits14_reg4.pth")
    jbu = init_lecun_normal_(JBUStack(384), torch.Generator().manual_seed(5))
    torch.save({f"upsampler.{k}": v for k, v in jbu.state_dict().items()},
               f"{root}/featup_jbu.pth")
    dec = init_lecun_normal_(NRDecoder(NRModelConfig(transformer_decoder_depth=2,
                                                     refine_up_depth=2)),
                             torch.Generator().manual_seed(6))
    torch.save(dec.state_dict(), f"{root}/model_nr.pth")


def verify_assets_phase(tmp: str) -> None:
    """Phase verify_assets: ``tools/verify_assets --assets-dir`` over the
    seeded checkpoints on the card: every check but the golden one (no demo
    images) passes and the exit is 0; the JBU kernel launches 4 times an NR
    forward (FeatUp's check: one, nr_model's: three) and the ChannelNorm
    forward once a decoder ChannelNorm but the skipped last resample's
    (12 at depths 1 / 1, 18 at 2 / 2); the moments kernel 6 times a DISTS,
    FR or NR forward (5 + 10 + 4)."""
    import io
    import os
    import re

    from nerf_qa_torch.config import NRModelConfig
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.layers import ChannelNorm
    from nerf_qa_torch.tools import verify_assets

    def cn_per_forward(trans, refine):
        dec = NRDecoder(NRModelConfig(transformer_decoder_depth=trans, refine_up_depth=refine))
        return sum(isinstance(m, ChannelNorm) for m in dec.modules()) - 1

    root = f"{tmp}/assets"
    os.makedirs(root)
    seeded_assets(root)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = verify_assets.main(["--assets-dir", root])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    lines = {m.group(1): m.group(2) for m in re.finditer(
        r"verify_assets: (\w+): (PASS|FAIL|SKIP) — (.*)", text.getvalue())}
    want = {"jbu": 4 * (1 + 3), "channelnorm": cn_per_forward(1, 1) + 3 * cn_per_forward(2, 2),
            "moments": 6 * (5 + 10 + 4)}
    if rc != 0 or set(lines.values()) != {"PASS"} or len(lines) != 6 or any(
            counts[k] != v for k, v in want.items()):
        raise AssertionError(f"verify_assets rc {rc}, launches {counts} (expected {want}): "
                             f"{text.getvalue()[-3000:]}")
    phase("verify_assets", rc=rc, checks=lines, launches=counts, expected_launches=want,
          seconds=seconds, report=text.getvalue().strip().splitlines())


def sweep_phase(tmp: str) -> None:
    """Phase sweep: ``tools/sweep --target fr --max-trials 3`` with the
    bundled FR config (bayes, 10 epochs a trial, the logistic head) over a
    synthetic tree of twelve videos, through run_fr with the stats cache on
    the card: every trial returns its objective and the moments kernel
    launches."""
    import io

    from nerf_qa_torch.tools import sweep
    from nerf_qa_torch.tools.make_synthetic_dataset import make_fr_tree

    data = f"{tmp}/sweep_data"
    # no fabricated DISTS column: the logistic head is fitted to the
    # random pyramid's real scores
    scores = make_fr_tree(data, scenes=("lego", "truck", "ship", "fortress"),
                          methods_per_scene=3, frames=4, hw=(288, 352), seed=4,
                          dists_col=False)
    config = Path(__file__).resolve().parent / "nerf_qa_torch/configs/sweep-fr-logistic.yaml"
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        hist = sweep.main(["--config", str(config), "--target", "fr",
                           "--max-trials", str(SWEEP_TRIALS), "--output-dir", f"{tmp}/sweep",
                           "--base-args", "--data-dir", data, "--scores-csv", scores,
                           "--folds", "2", "--batch-size", "8", "--num-workers", "2",
                           "--cache-stats"])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    objectives = [h["objective"] for h in hist]
    if len(hist) != SWEEP_TRIALS or counts["moments"] == 0 or not all(
            v is not None and math.isfinite(v) for v in objectives):
        raise AssertionError(f"sweep: objectives {objectives}, launches {counts}: "
                             f"{text.getvalue()[-3000:]}")
    phase("sweep", method=sweep.load_yaml(str(config))["method"], trials=SWEEP_TRIALS,
          objectives=objectives, params=[h["params"] for h in hist], seconds=seconds,
          launches=counts)


# -- many devices: the mesh, data parallelism, spatial sharding and
# processes --------------------------------------------------------------------

# the frames of parallel_scorer (drawn apart from the bound's, below)
PARALLEL_SEED = 22
# the bf16 bound of a frame's DISTS score between batch 128 and batch 64
# (cuDNN picks its bf16 conv kernels by batch size): the largest gap over
# 8 batches of 128 seeded 1080p pairs at 256², probes/cudnn_numerics.py
# (PERF.md §6). parallel_scorer splits 128 into two 64s: it holds its
# sharded scores bit-equal to the unsharded scorer on each half, and to
# the unsharded batch of 128 within this bound
DP_BF16_BOUND = 4.953145980834961e-05
DP_FP32_TOL = {"dists": 2e-5, "adists": 1e-4}  # tests/test_spatial_sharding.py's bars
SPATIAL_HW = (1088, 1920)  # 1080p padded to split over 4 · 16
SPATIAL_PAIRS = 2
SPATIAL_MODEL = (2, 4)
DP_SHARDS = 2  # the card's data mesh: [cuda:0] * 2
DP_NR_BATCH = 4
# (version, dtype, dropout) of parallel_train's NR steps
DP_NR_CASES = ((8, "bfloat16", 0.2), (8, "float32", 0.2), (1, "float32", 0.0))
DP_FR_BATCH = 32
SERVE_PARALLEL_FRAMES = 2


def cuda_mesh(n: int, model_parallel: int = 1):
    """A mesh of ``n`` copies of the card (the card's stand-in for n GPUs)."""
    from nerf_qa_torch.parallel.mesh import create_mesh

    return create_mesh([torch.device("cuda", 0)] * n, model_parallel=model_parallel)


def seeded_frames(gen, n: int, hw=FRAME_HW):
    d = torch.randint(0, 256, (n, *hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
    r = torch.randint(0, 256, (n, *hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
    return d, r


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def parallel_scorer(model, weights) -> dict[str, int]:
    """Phase parallel_scorer: FrameScorer over a [cuda:0] × 2 data mesh at
    batch 128 of uint8 1080p pairs resized to 256², bf16 and fp32 (moments
    kernel), against the unsharded scorer: 6 moments launches a shard;
    bit-equal to the unsharded scorer on each half (the batch each shard
    sees); against the unsharded batch of 128, bf16 within DP_BF16_BOUND
    and fp32 within 2e-5; frames/s of each in turns."""
    from nerf_qa_torch.config import DISTSConfig, true_fp32
    from nerf_qa_torch.eval.video_scorer import FrameScorer

    gen = torch.Generator(device="cuda").manual_seed(PARALLEL_SEED)
    d, r = seeded_frames(gen, BATCH)
    mesh = cuda_mesh(DP_SHARDS)
    rows, counts = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for dtype in ("bfloat16", "float32"):
        cfg = DISTSConfig(compute_dtype=dtype, stats_impl="kernel")
        single = FrameScorer(model, weights, cfg)
        sharded = FrameScorer(model, weights, cfg, mesh=mesh)
        precision = true_fp32 if dtype == "float32" else contextlib.nullcontext
        with precision():
            sharded.score_batch(d, r)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            s_sh = sharded.score_batch(d, r)
            counts[dtype] = launch_counts()
            s_un = single.score_batch(d, r)
            half = BATCH // DP_SHARDS
            halves = torch.cat([single.score_batch(d[i:i + half], r[i:i + half])
                                for i in range(0, BATCH, half)])
        gap = float((s_sh - s_un).abs().max())
        bar = DP_BF16_BOUND if dtype == "bfloat16" else DP_FP32_TOL["dists"]
        halves_equal = bool(torch.equal(s_sh, halves))
        if (counts[dtype]["moments"] != 6 * DP_SHARDS or not halves_equal or gap > bar
                or not bool(torch.isfinite(s_sh).all())):
            raise AssertionError(f"parallel_scorer {dtype}: launches {counts[dtype]}, "
                                 f"bit-equal halves {halves_equal}, gap {gap} (bar {bar})")
        fps = {"unsharded": [], "sharded": []}
        for name, sc in (("unsharded", single), ("sharded", sharded),
                         ("sharded", sharded), ("unsharded", single)):
            with precision():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    sc.score_batch(d, r)
                end.record()
                end.synchronize()
            fps[name].append(3 * BATCH / (start.elapsed_time(end) / 1e3))
        rows[dtype] = dict(launches=counts[dtype], max_gap=gap, bar=bar,
                           bit_equal_to_unsharded_halves=halves_equal,
                           frames_per_s=fps)
    phase("parallel_scorer", mesh="[cuda:0] x 2 (data)", batch=BATCH,
          frame_hw=list(FRAME_HW), seed=PARALLEL_SEED, **rows, peak_mem_gib=peak_gib())
    return counts["bfloat16"]


class SlabCheck:
    """Patch ``parallel.spatial``'s kernel wrappers inside the block so
    that every call (a slab's moment sums, a block's T/S map) is also held
    against its plain version on the same inputs; the comparisons launch
    nothing."""

    def __init__(self):
        self.moments: list[float] = []
        self.tsd: list[float] = []
        self.shapes: dict[str, list] = {"moments": [], "tsd": []}
        self.tsd_calls: list[tuple] = []  # each block's T/S arguments

    def __enter__(self):
        from nerf_qa_torch.ops.cuda import moments, windowed_tsd
        from nerf_qa_torch.parallel import spatial

        self._real = (spatial.moment_sums, spatial.windowed_tsd)

        def moment_sums(fx, fy):
            got = moments.moment_sums(fx, fy)
            hw = fx.shape[1] * fx.shape[2]
            self.moments.append(check_close(
                moments.stats_from_sums(got, hw),
                moments.stats_from_sums(moments.moment_sums_plain(fx, fy), hw),
                RTOL, ATOL, f"slab moments {tuple(fx.shape)} vs plain"))
            self.shapes["moments"].append(list(fx.shape))
            return got

        def tsd(fx, fy, ps, w, ws, inv_x=None, inv_y=None):
            got = windowed_tsd.windowed_tsd(fx, fy, ps, w, ws, inv_x=inv_x, inv_y=inv_y)
            want = windowed_tsd.windowed_tsd_plain(fx, fy, ps, w, ws, inv_x, inv_y)
            self.tsd.append(tsd_check(got, want, f"block T/S {tuple(fx.shape)}"))
            self.shapes["tsd"].append(list(fx.shape))
            self.tsd_calls.append((fx, fy, ps, w, ws, inv_x, inv_y))
            return got

        spatial.moment_sums, spatial.windowed_tsd = moment_sums, tsd
        return self

    def __exit__(self, *exc):
        from nerf_qa_torch.parallel import spatial

        spatial.moment_sums, spatial.windowed_tsd = self._real


def spatial_pairs(gen):
    d, r = seeded_frames(gen, SPATIAL_PAIRS, SPATIAL_HW)
    return d.float() / 255.0, r.float() / 255.0


def spatial_dists_phase(model, weights) -> dict[str, int]:
    """Phase spatial_dists: two pairs at 1088 × 1920, H split 2 and 4 ways
    ([cuda:0] × model axis): fp32 and bf16 against the single-device
    full-resolution path (fp32 within 2e-5), 6 moments launches a slab,
    every slab's sums held to the plain sums on the same slab, ms per
    batch and peak memory."""
    from nerf_qa_torch.config import DISTSConfig, true_fp32
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.parallel.mesh import replicate
    from nerf_qa_torch.parallel.spatial import spatial_dists_forward

    gen = torch.Generator(device="cuda").manual_seed(31)
    x, y = spatial_pairs(gen)
    w = weights.to("cuda")
    rows, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = DISTSConfig(compute_dtype=dtype, stats_impl="kernel")
        precision = true_fp32 if dtype == "float32" else contextlib.nullcontext
        with torch.no_grad(), precision():
            want = dists.forward(model, w, x, y, cfg)
            for mp in SPATIAL_MODEL:
                mesh = cuda_mesh(mp, mp)
                models = replicate(mesh, model)
                spatial_dists_forward(models, w, x, y, mesh, cfg)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                got = spatial_dists_forward(models, w, x, y, mesh, cfg)
                counts = launch_counts()
                peak = peak_gib()
                with SlabCheck() as check:
                    again = spatial_dists_forward(models, w, x, y, mesh, cfg)
                gap = float((got - want).abs().max())
                bad = (counts["moments"] != 6 * mp or len(check.moments) != 6 * mp
                       or not torch.equal(got, again) or not bool(torch.isfinite(got).all())
                       or (dtype == "float32" and gap > DP_FP32_TOL["dists"]))
                if bad:
                    raise AssertionError(f"spatial DISTS {dtype} model {mp}: gap {gap}, "
                                         f"launches {counts}, slab checks "
                                         f"{len(check.moments)}")
                ms = time_ms(lambda: spatial_dists_forward(models, w, x, y, mesh, cfg), 3)
                rows[f"{dtype} model {mp}"] = dict(
                    scores=got.tolist(), single_device=want.tolist(), max_gap=gap,
                    moments_launches=counts["moments"],
                    slab_moments_max_abs_err=max(check.moments),
                    slab_shapes=check.shapes["moments"][:6], ms_per_batch=ms,
                    peak_mem_gib=peak)
                launches[f"{dtype} model {mp}"] = counts["moments"]
            rows[f"{dtype} single device ms"] = time_ms(
                lambda: dists.forward(model, w, x, y, cfg), 3)
    phase("spatial_dists", pairs=SPATIAL_PAIRS, frame_hw=list(SPATIAL_HW),
          fp32_tol=DP_FP32_TOL["dists"], **rows)
    return launches


def spatial_adists_phase(model) -> dict[str, int]:
    """Phase spatial_adists: ADISTS of the same two 1088 × 1920 pairs with
    H split 2 and 4 ways, scores and ``as_map``, fp32 and bf16, against the
    single-device forward (fp32 within 1e-4): one T/S launch per windowed
    stage (all six at this size) per channel block, every block's map held
    to the plain map on the same block, the T/S kernel's ms on each block,
    ms per batch and peak memory."""
    from nerf_qa_torch.config import ADISTSConfig
    from nerf_qa_torch.core import adists
    from nerf_qa_torch.ops.cuda import windowed_tsd
    from nerf_qa_torch.parallel.mesh import replicate
    from nerf_qa_torch.parallel.spatial import spatial_adists_forward

    gen = torch.Generator(device="cuda").manual_seed(31)
    x, y = spatial_pairs(gen)
    rows, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = ADISTSConfig(compute_dtype=dtype)
        with torch.no_grad():
            want = adists.forward(model, x, y, cfg, as_loss=False)
            want_map = adists.forward(model, x, y, cfg, as_map=True)
            for mp in SPATIAL_MODEL:
                mesh = cuda_mesh(mp, mp)
                models = replicate(mesh, model)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                got = spatial_adists_forward(models, x, y, mesh, cfg, as_loss=False)
                counts = launch_counts()
                peak = peak_gib()
                with SlabCheck() as check:
                    got_map = spatial_adists_forward(models, x, y, mesh, cfg, as_map=True)
                gap = float((got - want).abs().max())
                map_gap = float((got_map - want_map).abs().max())
                bad = (counts["windowed_tsd"] != 6 * mp or len(check.tsd) != 6 * mp
                       or not bool(torch.isfinite(got).all())
                       or (dtype == "float32" and max(gap, map_gap) > DP_FP32_TOL["adists"]))
                if bad:
                    raise AssertionError(f"spatial ADISTS {dtype} model {mp}: gaps {gap} "
                                         f"{map_gap}, launches {counts}, block checks "
                                         f"{len(check.tsd)}")
                ms = time_ms(lambda: spatial_adists_forward(models, x, y, mesh, cfg,
                                                            as_loss=False), 2)
                # the T/S kernel per block (stage 0's blocks hold one
                # channel at model 4, one of them all padding)
                block_ms = [[list(a[0].shape), time_ms(
                    lambda a=a: windowed_tsd.windowed_tsd(*a[:5], inv_x=a[5], inv_y=a[6]),
                    5)] for a in check.tsd_calls[:6 * mp]]
                del check.tsd_calls
                rows[f"{dtype} model {mp}"] = dict(
                    scores=got.tolist(), single_device=want.tolist(), max_gap=gap,
                    map_max_gap=map_gap, tsd_launches=counts["windowed_tsd"],
                    block_tsd_max_abs_err=max(check.tsd), tsd_ms_per_block=block_ms,
                    ms_per_batch=ms, peak_mem_gib=peak)
                launches[f"{dtype} model {mp}"] = counts["windowed_tsd"]
            rows[f"{dtype} single device ms"] = time_ms(
                lambda: adists.forward(model, x, y, cfg, as_loss=False), 2)
    phase("spatial_adists", pairs=SPATIAL_PAIRS, frame_hw=list(SPATIAL_HW),
          fp32_tol=DP_FP32_TOL["adists"], **rows)
    return launches


@contextlib.contextmanager
def dp_compare_mode(dtype: str, run: str):
    """The convolutions of parallel_train's compared NR steps: cuDNN's
    deterministic algorithms, except that fp32 steps run without cuDNN
    (PyTorch's own GEMM convolutions) unless ``run`` ends in "_cudnn".
    cuDNN picks its fp32 algorithms by batch size, and between batch 4
    and its halves they differ by ~1e-4 of the largest decoder gradient
    (the "_cudnn" pair, reported beside), as large as the bar; the
    comparison is of the sharding, so both sides take one algorithm."""
    if dtype == "float32" and not run.endswith("_cudnn"):
        with torch.backends.cudnn.flags(enabled=False):
            yield
        return
    with deterministic_convs():
        yield


def captured_step(trainer, *batch) -> tuple[dict, dict]:
    """One NR training step's losses and the decoder gradients the
    optimizer received."""
    grads = {}

    def keep(opt, args, kwargs):
        for n, p in trainer.model.decoder.named_parameters():
            grads[n] = torch.zeros_like(p) if p.grad is None else p.grad.clone()

    handle = trainer.optimizer.register_step_pre_hook(keep)
    try:
        losses = trainer.train_step(*batch)
    finally:
        handle.remove()
    return {k: float(v) for k, v in losses.items()}, grads


def parallel_train(vgg) -> dict[str, dict]:
    """Phase parallel_train: the trainers over a [cuda:0] × 2 data mesh
    against their unsharded steps from identical weights. FRTrainer at
    batch 32 (fp32 and bf16 pyramids, the logistic head): the image step's
    loss and head and α/β gradients (fp32 at fr_train_path's bars, 1e-5 /
    1e-4; bf16 at the NR training bars, 1e-4 / 5e-2, the pyramid's bits
    moving with its batch), the cached step's loss, 6 moments launches a
    shard. NRTrainer's gt step at batch 4 at full width (DP_NR_CASES: v8
    bf16, and v8 with fp32 VGG and decoder, dropout 0.2; v1, a BatchNorm
    generation, fp32, no dropout, its running averages within 1e-4), the
    same generator state, the compared steps in one convolution algorithm
    (``dp_compare_mode``): losses within 1e-5 (fp32) / 1e-4 (bf16), each
    decoder gradient within 1e-4 / 5e-2 of its largest
    (``resolved_grad_gaps``: of RESOLVED of the decoder's largest where
    the tensor's own is smaller, v1's conv biases before BatchNorms), v1's
    within the v1-v6 bars on the card, VERSION_GRAD_RTOL per tensor and
    VERSION_GRAD_L2 as a whole (its fp32 gradient moves by about 1e-2 of a
    tensor when the batch's rows are merely permuted: the ``permuted``
    control, beside the unsharded step's own repeat and the cuDNN pair).
    Those bars must catch a planted fault, every run: v1's sharded step
    with the BatchNorm sums' gradient cut between shards
    (``own_rows_only``), which must fail them. The JBU and ChannelNorm
    launches once per shard. Pairs/s and frames/s, sharded and
    unsharded."""
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig, TrainConfig
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.layers import init_lecun_normal_
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.parallel.mesh import ShardGroup
    from nerf_qa_torch.train.nr_train import NRTrainer

    real_sum = ShardGroup.sum

    def own_rows_only(self, index, t):
        # the planted fault: the global sums' values, with a gradient that
        # reaches only the shard's own rows
        return t + (real_sum(self, index, t) - t).detach()

    gen = torch.Generator(device="cuda").manual_seed(41)
    mesh = cuda_mesh(DP_SHARDS)
    out, launches = {}, {}
    dist, ref, targets = fr_batch(gen, DP_FR_BATCH, 256)
    init_x = np.linspace(0.02, 0.3, 8)
    init_y = 1 + 4 / (1 + np.exp((init_x - 0.15) / 0.04))
    for dtype in FR_DTYPES:
        single = make_fr_trainer(vgg, dtype, "kernel")
        sharded = make_fr_trainer(vgg, dtype, "kernel", mesh=mesh)
        params, _ = single.init(init_x, init_y)
        with true_fp32_if(getattr(torch, dtype)):
            reset_launches()
            loss_s, grads_s = fr_grads(sharded, params, dist, ref, targets)
            counts_s = launch_counts()["moments"]
            reset_launches()
            loss_u, grads_u = fr_grads(single, params, dist, ref, targets)
            counts_u = launch_counts()["moments"]
            cache = single.pair_stats(dist, ref).transpose(0, 1)
            cached = [float(tr.train_step_cached(tr.to_device(params),
                                                 tr.optimizer.init(tr.to_device(params)),
                                                 cache, targets)[2])
                      for tr in (single, sharded)]
        loss_gap = abs(loss_s - loss_u)
        gaps = fr_grad_gaps(grads_s, grads_u)
        worst = max(gaps, key=gaps.get)
        bars = ((FR_PLAIN_LOSS_ATOL[dtype], FR_PLAIN_GRAD_RTOL[dtype]) if dtype == "float32"
                else (TRAIN_PLAIN_LOSS_ATOL[dtype], TRAIN_PLAIN_GRAD_RTOL[dtype]))
        if (counts_s != 6 * DP_SHARDS or counts_u != 6 or loss_gap > bars[0]
                or gaps[worst] > bars[1] or abs(cached[0] - cached[1]) > bars[0]):
            raise AssertionError(f"FR {dtype} sharded vs unsharded: loss {loss_gap}, "
                                 f"gradient {worst} {gaps[worst]}, cached {cached}, "
                                 f"launches {counts_s} / {counts_u}")
        rates = {}
        for name, tr in (("unsharded", single), ("sharded", sharded), ("sharded", sharded),
                         ("unsharded", single)):
            p = tr.to_device(params)
            opt = tr.optimizer.init(p)
            with true_fp32_if(getattr(torch, dtype)):
                tr.train_step(p, opt, dist, ref, targets)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    p, opt, _, _ = tr.train_step(p, opt, dist, ref, targets)
                torch.cuda.synchronize()
            rates.setdefault(name, []).append(3 * DP_FR_BATCH / (time.perf_counter() - t0))
        out[f"fr {dtype}"] = dict(loss_gap=loss_gap, worst_grad=[worst, gaps[worst]],
                                  cached_loss_gap=abs(cached[0] - cached[1]), bars=bars,
                                  moments_launches={"sharded": counts_s,
                                                    "unsharded": counts_u},
                                  pairs_per_s=rates)
        launches[f"fr {dtype}"] = counts_s
        del single, sharded

    weights, vit, jbu = nr_backbones()
    batch = train_batch(gen, DP_NR_BATCH)
    # bf16: the CLI's default (bf16 VGG and decoder); fp32: the parity path
    # (fp32 VGG and decoder). A bf16 VGG's features move by an ulp with
    # their batch (cuDNN, PERF.md §6), which an fp32 decoder's first stage
    # would show as a gradient gap of its own. v1 runs without dropout, so
    # that the same step on the batch's rows permuted is the same function:
    # its gap shows what reduction order alone does to v1's gradient
    for version, dtype, rate in DP_NR_CASES:
        cfg = NRModelConfig(version=version, decoder_dtype=dtype, dropout_rate=rate,
                            dists=DISTSConfig(compute_dtype=dtype))
        runs = [("unsharded", None, batch), ("sharded", mesh, batch)]
        if version < 7:
            perm = torch.tensor([2, 3, 0, 1], device="cuda")
            runs += [("again", None, batch),
                     ("permuted", None, tuple(t[perm] for t in batch)),
                     ("fault_own_rows_only", mesh, batch)]
        elif dtype == "float32":
            runs += [("unsharded_cudnn", None, batch), ("sharded_cudnn", mesh, batch)]
        # one decoder, drawn once as NRTrainer.init draws it, copied into
        # every run
        decoder = init_lecun_normal_(
            NRDecoder(cfg, sem_dim=vit.embed_dim, qkv_bias=True, layer_scale=True),
            torch.Generator().manual_seed(0))
        res = {}
        for name, m, args in runs:
            model = NRModel(vgg, weights, cfg, vit=vit, jbu=jbu if version >= 7 else None,
                            decoder=copy.deepcopy(decoder))
            trainer = NRTrainer(model, TrainConfig(lr=TRAIN_LR, schedule="constant",
                                                   batch_size=DP_NR_BATCH),
                                steps_per_epoch=1, mesh=m)
            trainer.set_decoder(model.decoder)
            reset_launches()
            planted = contextlib.nullcontext()
            if name.startswith("fault"):
                planted = _restoring(ShardGroup, "sum", real_sum)
                ShardGroup.sum = own_rows_only
            with planted, dp_compare_mode(dtype, name):
                losses, grads = captured_step(trainer, *args)
            counts = launch_counts()
            state = {k: v.clone() for k, v in model.decoder.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            fps = None
            if name in ("unsharded", "sharded"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    trainer.train_step(*args)
                torch.cuda.synchronize()
                fps = 3 * DP_NR_BATCH / (time.perf_counter() - t0)
            res[name] = (losses, grads, state, counts, fps, trainer.generator.get_state())
            del trainer, model
        (lu, gu, su, cu, fu, genu), (ls, gs, ss, cs_, fs, gens) = (res["unsharded"],
                                                                  res["sharded"])
        loss_gap = max(abs(ls[k] - lu[k]) for k in lu)
        gaps = resolved_grad_gaps(gs, gu)
        worst = max(gaps, key=gaps.get)
        top = max(float(g.abs().max()) for g in gu.values())
        of_largest = max(float((gs[k] - gu[k]).abs().max()) for k in gu) / top
        stats_gap = max([float((ss[k] - su[k]).abs().max())
                         / max(float(su[k].abs().max()), 1e-12) for k in su] or [0.0])
        bars = (TRAIN_PLAIN_LOSS_ATOL[dtype],
                TRAIN_PLAIN_GRAD_RTOL[dtype] if version >= 7 else VERSION_GRAD_RTOL)
        grad_l2 = rel_l2(gs, gu)
        controls = {name: [max(resolved_grad_gaps(res[name][1], gu).values()),
                           rel_l2(res[name][1], gu)]
                    for name in ("again", "permuted", "fault_own_rows_only") if name in res}
        fault_caught = ("fault_own_rows_only" not in controls
                        or controls["fault_own_rows_only"][0] > bars[1]
                        or controls["fault_own_rows_only"][1] > VERSION_GRAD_L2)
        if "sharded_cudnn" in res:
            a, b = res["sharded_cudnn"][1], res["unsharded_cudnn"][1]
            controls["cudnn_deterministic_of_largest"] = max(
                float((a[k] - b[k]).abs().max()) for k in b) / max(
                float(g.abs().max()) for g in b.values())
        row = dict(loss_gap=loss_gap, grad_gap_of_largest=of_largest,
                   worst_grad=[worst, gaps[worst]], grad_l2=grad_l2, bars=bars,
                   controls_worst_grad_and_l2=controls, fault_caught=fault_caught,
                   batchnorm_stats_rel_gap=stats_gap if su else None,
                   launches={"unsharded": cu, "sharded": cs_},
                   frames_per_s={"unsharded": fu, "sharded": fs})
        out[f"nr v{version} {dtype}"] = row
        ok = (loss_gap <= bars[0] and gaps[worst] <= bars[1] and torch.equal(genu, gens)
              and (version >= 7 or grad_l2 <= VERSION_GRAD_L2) and fault_caught
              and (version >= 7) == (not su) and stats_gap <= 1e-4
              and all(cs_[k] == cu[k] * DP_SHARDS
                      for k in ("jbu", "channelnorm", "channelnorm_bwd")))
        if not ok:
            phase("parallel_train_failed", **out)
            raise AssertionError(f"NR v{version} {dtype} sharded vs unsharded: {row}")
        launches[f"nr v{version} {dtype}"] = cs_
    phase("parallel_train", mesh="[cuda:0] x 2 (data)", fr_batch=DP_FR_BATCH,
          nr_batch=DP_NR_BATCH, **out)
    return launches


def mixed_mesh() -> None:
    """Phase mixed_mesh: meshes of two distinct devices, [cuda:0, cpu], so
    that every shard's model and weights are copies on their own device and
    the cross-device paths run: FrameScorer (fp32, 4 uint8 90 × 120 pairs
    → 64²), spatial DISTS (2 pairs at 64 × 48, the CPU's slab below the
    card's), and NRTrainer v1 (BatchNorm sums across the two devices) and
    v8 (dropout 0.2) at 64² / 56², batch 4, each against the card alone at
    the card-against-CPU bars: scores and losses SCORE_ATOL, decoder
    gradients TRAIN_CPU_GRAD_RTOL for v8 and VERSION_GRAD_RTOL and
    VERSION_GRAD_L2 for v1 (``resolved_grad_gaps``, ``rel_l2``); the
    model copies made by ``replicate``; the card's shard launches its kernels, the
    CPU's their plain versions."""
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights, resolve_vgg_params
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig, TrainConfig, true_fp32
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.eval.video_scorer import FrameScorer
    from nerf_qa_torch.ops.resize import resize_bilinear
    from nerf_qa_torch.parallel.mesh import create_mesh, replicate
    from nerf_qa_torch.parallel.spatial import spatial_dists_forward
    from nerf_qa_torch.train.nr_train import NRTrainer

    gen = torch.Generator(device="cuda").manual_seed(51)
    mesh = create_mesh(["cuda:0", "cpu"])
    cfg = DISTSConfig(stats_impl="kernel")
    weights = resolve_dists_weights(cfg)
    vgg = resolve_vgg_params(seed=0)
    d, r = (t.cpu() for t in seeded_frames(gen, 4, (90, 120)))
    card = FrameScorer(vgg, weights, cfg, resize_to=(64, 64)).score_frames(d, r, 4)
    reset_launches()
    mixed = FrameScorer(vgg, weights, cfg, resize_to=(64, 64), mesh=mesh).score_frames(
        d, r, 4)
    out = {"scorer": dict(gap=float(abs(mixed - card).max()),
                          moments_launches=launch_counts()["moments"])}
    x = torch.rand((2, 64, 48, 3), generator=gen, device="cuda")
    y = (x + 0.05 * torch.randn(x.shape, generator=gen, device="cuda")).clamp(0, 1)
    w = weights.to("cuda")
    with torch.no_grad(), true_fp32():
        want = dists.forward(vgg, w, x, y, cfg)
        reset_launches()
        smesh = create_mesh(["cuda:0", "cpu"], 2)
        got = spatial_dists_forward(replicate(smesh, vgg), w, x, y, smesh, cfg)
    out["spatial"] = dict(gap=float((got - want).abs().max()),
                          moments_launches=launch_counts()["moments"])
    ok = (out["scorer"]["gap"] <= SCORE_ATOL and out["scorer"]["moments_launches"] == 6
          and out["spatial"]["gap"] <= SCORE_ATOL and out["spatial"]["moments_launches"] == 6)
    gt = torch.rand((4, 64, 64, 3), generator=gen, device="cuda")
    render = (gt + 0.05 * torch.randn(gt.shape, generator=gen, device="cuda")).clamp(0, 1)
    batch = (gt, render, resize_bilinear(render, 56, 56))
    for version in (1, 8):
        model = small_nr(NRModelConfig(version=version, transformer_decoder_depth=1,
                                       decoder_dtype="float32",
                                       dists=DISTSConfig(compute_dtype="float32")))
        res = {}
        for name, m in (("card", None), ("mixed", mesh)):
            trainer = NRTrainer(copy.deepcopy(model), TrainConfig(
                lr=1e-3, schedule="constant", batch_size=4), steps_per_epoch=1, mesh=m)
            trainer.init(seed=0)
            reset_launches()
            losses, grads = captured_step(trainer, *batch)
            state = {k: v.clone() for k, v in trainer.model.decoder.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            res[name] = (losses, {k: g.cpu() for k, g in grads.items()}, state,
                         launch_counts(), trainer.generator.get_state(),
                         sorted(str(dv) for dv, m in (trainer._replicas or {}).items()
                                if m is not trainer.model))
        (cl, cg, cs_, cc, cgen, _), (ml, mg, ms, mc, mgen, copies) = res["card"], res["mixed"]
        gaps = resolved_grad_gaps(mg, cg)
        worst = max(gaps, key=gaps.get)
        stats_gap = max([float((ms[k] - cs_[k]).abs().max())
                         / max(float(cs_[k].abs().max()), 1e-12) for k in cs_] or [0.0])
        row = dict(loss_gap=max(abs(ml[k] - cl[k]) for k in cl),
                   worst_grad=[worst, gaps[worst]], grad_l2=rel_l2(mg, cg),
                   batchnorm_stats_rel_gap=stats_gap,
                   copies=copies, launches={"card": cc, "mixed": mc},
                   same_generator=bool(torch.equal(cgen, mgen)))
        out[f"nr v{version}"] = row
        bar = TRAIN_CPU_GRAD_RTOL if version >= 7 else VERSION_GRAD_RTOL
        row["grad_bar"] = bar
        ok = ok and (row["loss_gap"] <= SCORE_ATOL and gaps[worst] <= bar
                     and (version >= 7 or row["grad_l2"] <= VERSION_GRAD_L2)
                     and stats_gap <= TRAIN_CPU_GRAD_RTOL and copies == ["cpu"]
                     and row["same_generator"]
                     and mc == cc)  # the card's shard runs the kernels, the CPU's none
    phase("mixed_mesh", mesh="[cuda:0, cpu]", **out)
    if not ok:
        raise AssertionError(f"mixed mesh: {out}")


class worker_run:
    """tests/torch_multihost_worker.py started as ``n`` processes of one
    world on the card; ``wait()`` returns their outputs (each must exit
    0) and stops every process it started."""

    def __init__(self, n: int, **env):
        import socket

        root = Path(__file__).resolve().parent
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        base = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    NUM_PROCESSES=str(n), WORKER_DEVICE="cuda:0", PYTHONPATH=str(root),
                    **env)
        self.procs = [subprocess.Popen(
            [sys.executable, str(root / "tests" / "torch_multihost_worker.py")],
            env=dict(base, PROCESS_ID=str(i)), cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(n)]

    def wait(self) -> list[str]:
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in self.procs):
            raise AssertionError(f"worker rcs {[p.returncode for p in self.procs]}: "
                                 + " | ".join(o[-1500:] for o in outs))
        return outs


def multiprocess() -> None:
    """Phase multiprocess: ``maybe_initialize`` forms a world of one over
    NCCL on the card and takes the FR step there; then two processes share
    the card over gloo (LOCAL_WORLD_SIZE=2: NCCL allows one rank a card)
    and take one data-parallel FR step through HostShardedSampler: their
    shards are disjoint and cover the set, and both end with bit-identical
    parameters. The three processes run at once."""
    def lines(out, tag):
        return [line for line in out.splitlines() if line.startswith(tag)]

    t0 = time.perf_counter()
    one_world, two_world = worker_run(1), worker_run(2, LOCAL_WORLD_SIZE="2")
    try:
        one = one_world.wait()[0]
    finally:
        outs = two_world.wait()
    seconds = time.perf_counter() - t0
    if lines(one, "BACKEND") != ["BACKEND nccl 1"]:
        raise AssertionError(f"world of one: {one[-1500:]}")
    shards = [json.loads(lines(o, f"SHARD {i} ")[0].split(" ", 2)[2])
              for i, o in enumerate(outs)]
    p0, p1 = lines(outs[0], "PARAMS"), lines(outs[1], "PARAMS")
    ok = (all(lines(o, "BACKEND") == ["BACKEND gloo 2"] for o in outs)
          and set(shards[0]).isdisjoint(shards[1])
          and sorted(shards[0] + shards[1]) == [0, 1, 2, 3]
          and lines(outs[0], "LOSS") == lines(outs[1], "LOSS") and p0 and p0 == p1)
    if not ok:
        raise AssertionError(f"two processes: {outs[0][-1500:]} | {outs[1][-1500:]}")
    loss_one = float(lines(one, "LOSS")[0].split()[1])
    loss_two = float(lines(outs[0], "LOSS")[0].split()[1])
    phase("multiprocess", world_of_one="nccl", two_processes="gloo on cuda:0",
          seconds_both_at_once=seconds, shards=shards,
          params_bit_identical=True, loss_world_of_one=loss_one, loss_two_processes=loss_two,
          params=p0)


def serve_parallel(model) -> dict[str, dict]:
    """Phase serve_parallel: ``tools.serve`` with --data-parallel and with
    --spatial 2 --full-size (fp32, --metric both, batch 4), its mesh built
    from ``local_devices`` standing in as [cuda:0] × 2, on three requests
    of two 1088 × 1920 PNG pairs: each response against the scorers
    called directly on the same frames (DISTS within 2e-5, ADISTS 1e-4),
    and the kernels' launches."""
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights
    from nerf_qa_torch.config import ADISTSConfig, DISTSConfig, true_fp32
    from nerf_qa_torch.eval.video_scorer import FrameScorer
    from nerf_qa_torch.parallel import mesh as meshlib
    from nerf_qa_torch.tools import score, serve

    rng = np.random.default_rng(13)
    weights = resolve_dists_weights(DISTSConfig())
    direct = FrameScorer(model, weights, DISTSConfig(stats_impl="kernel"), resize_to=None)
    acfg = ADISTSConfig()
    rows = {}
    real = meshlib.local_devices
    meshlib.local_devices = lambda: [torch.device("cuda", 0)] * DP_SHARDS
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            reqs = []
            for k in range(3):
                ref = video_u8(rng, SERVE_PARALLEL_FRAMES, SPATIAL_HW, base_shift=0.05 * k)
                dist = np.clip(ref.astype(np.int16) + rng.integers(-15, 16, ref.shape),
                               0, 255).astype(np.uint8)
                reqs.append({"id": k, "ref": write_video(root, f"r{k}", ref, False),
                             "dist": write_video(root, f"d{k}", dist, False)})
            for flags in (["--data-parallel"], ["--spatial", "2"]):
                args = serve.build_parser().parse_args(
                    ["--stdio", "--fp32", "--metric", "both", "--batch-size", "4",
                     "--full-size", "--no-warmup", *flags])
                svc = serve.ScoringService(args, model, weights)
                try:
                    reset_launches()
                    t0 = time.perf_counter()
                    resp = [svc.handle(q) for q in reqs]
                    secs = time.perf_counter() - t0
                    counts = launch_counts()
                    steps = {k: b.device_steps for k, b in svc.batchers.items()}
                finally:
                    svc.close()
                gaps = {"dists": 0.0, "adists": 0.0}
                for r, q in zip(resp, reqs):
                    if "error" in r:
                        raise AssertionError(f"serve {flags}: {r}")
                    d = score._load_frames(q["dist"], False, False)
                    f = score._load_frames(q["ref"], False, False)
                    with true_fp32():
                        wd = direct.score_frames(d, f, 4)
                        wa = score.adists_batch(model, d, f, acfg).cpu().numpy()
                    gaps["dists"] = max(gaps["dists"], _gap(r["dists_frames"], wd))
                    gaps["adists"] = max(gaps["adists"], _gap(r["adists_frames"], wa))
                if any(gaps[k] > DP_FP32_TOL[k] for k in gaps):
                    raise AssertionError(f"serve {flags} vs direct: {gaps}")
                rows[" ".join(flags)] = dict(seconds=secs, gaps=gaps, launches=counts,
                                             device_steps=steps,
                                             dists=[r["dists"] for r in resp])
    finally:
        meshlib.local_devices = real
    phase("serve_parallel", devices="[cuda:0] x 2", frame_hw=list(SPATIAL_HW),
          requests=3, frames_per_request=SERVE_PARALLEL_FRAMES, **rows)
    return rows


def bench_op_phase(gen) -> None:
    """Phase bench_op: the moments kernel at the FR path's stage shapes
    (batch 128, bf16) timed by ``utils.benchtime.bench_op`` (what
    ``time_ms`` calls: each run's output feeds a device scalar) and by a
    bare CUDA-event loop of the same calls, in turns."""
    from nerf_qa_torch.ops.cuda import moments
    from nerf_qa_torch.utils.benchtime import bench_op

    rows = []
    for (h, w), c in zip(STAGE_HW, STAGE_C):
        fx, fy = feature_pair((BATCH, h, w, c), torch.bfloat16, gen)

        def bare(iters=20):
            moments.moment_sums(fx, fy)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                moments.moment_sums(fx, fy)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters

        op = lambda v: moments.moment_sums(v, fy)  # noqa: E731
        rows.append({"shape": [BATCH, h, w, c],
                     "bench_op_ms": [1e3 * bench_op(op, fx), 1e3 * bench_op(op, fx)],
                     "bare_loop_ms": [bare(), bare()]})
        del fx, fy
    phase("bench_op", kernel="moments", dtype="bfloat16", rows=rows,
          bench_op_total_ms=sum(min(r["bench_op_ms"]) for r in rows),
          bare_loop_total_ms=sum(min(r["bare_loop_ms"]) for r in rows))


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
        bound_ms, by = moments_bound(shape, fx.element_size())
        bound_by.add(by)

        def library():
            # yardstick only: no single call gives all five moments
            torch.var_mean(fx, dim=(1, 2), correction=0)
            torch.var_mean(fy, dim=(1, 2), correction=0)
            (fx * fy).mean(dim=(1, 2))

        row = {
            "plain_ms": time_ms(lambda: moments.moment_sums_plain(fx, fy)),
            "ms": time_ms(lambda: moments.moment_sums(fx, fy)),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms,
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

    # 9b. the rest of NR training: the score-map objective, remat, v1-v6,
    # the token cache, the full NR CLI run and the sub-pixel choice
    for name, run in (("nr_scoremap_train", lambda: nr_scoremap_train(model, gen)),
                      ("nr_remat", lambda: nr_remat(model, gen)),
                      ("nr_versions", lambda: nr_versions(model, gen)),
                      ("nr_feature_cache", lambda: nr_feature_cache(model, gen)),
                      ("nr_cli_full", nr_cli_full),
                      ("subpixel_choice", lambda: subpixel_choice(gen))):
        t0 = time.perf_counter()
        run()
        phase("timing_of_phase", which=name, seconds=time.perf_counter() - t0)

    # 10. FR training at full width in both pyramid dtypes, the card's fp32
    # step against the CPU path, the FR CLIs and the FR quality certificate
    fr_train_path(model, gen)
    fr_train_cpu_parity(gen)
    fr_cli_run()
    fr_quality()

    # 11. the data feed and the scoring service: the native decoder, mp4s
    # through the score CLI, the service at full width over HTTP (all four
    # forward kernels), its CLI in a subprocess, and the feed benchmark
    t0 = time.perf_counter()
    built = native_decoder()
    phase("timing_of_phase", which="native_decoder", seconds=time.perf_counter() - t0)
    for name, run in (("mp4_path", lambda: mp4_path(built)),
                      ("serve_path", lambda: serve_path(model, built)),
                      ("serve_cli", lambda: serve_cli(model)),
                      ("feed", lambda: feed(model))):
        t0 = time.perf_counter()
        run()
        phase("timing_of_phase", which=name, seconds=time.perf_counter() - t0)

    # 12. the comparison and readiness tools: the IQA metrics at prep_fr's
    # sizes, prep_fr --iqa with DISTS and ADISTS, the results tables,
    # golden_check, retrieval, verify_assets and the sweep driver
    with tempfile.TemporaryDirectory() as tmp:
        prep_csv = []
        for name, run in (("iqa_metrics", lambda: iqa_metrics(model)),
                          ("prep_fr_iqa", lambda: prep_csv.append(prep_fr_iqa(tmp))),
                          ("results_tables", lambda: results_tables(tmp, prep_csv[0])),
                          ("golden_check", lambda: golden_phase(tmp)),
                          ("retrieval", lambda: retrieval_phase(model)),
                          ("verify_assets", lambda: verify_assets_phase(tmp)),
                          ("sweep", lambda: sweep_phase(tmp))):
            t0 = time.perf_counter()
            run()
            phase("timing_of_phase", which=name, seconds=time.perf_counter() - t0)

    # 13. many devices on the one card ([cuda:0] × n stands in for n GPUs):
    # the data-parallel scorer, spatial DISTS and ADISTS at 1088 × 1920,
    # the data-parallel trainers, processes over NCCL and gloo, the
    # service's --data-parallel and --spatial, and bench_op's figure
    for name, run in (("parallel_scorer", lambda: parallel_scorer(model, weights)),
                      ("spatial_dists", lambda: spatial_dists_phase(model, weights)),
                      ("spatial_adists", lambda: spatial_adists_phase(model)),
                      ("parallel_train", lambda: parallel_train(model)),
                      ("mixed_mesh", mixed_mesh),
                      ("multiprocess", multiprocess),
                      ("serve_parallel", lambda: serve_parallel(model)),
                      ("bench_op", lambda: bench_op_phase(gen))):
        t0 = time.perf_counter()
        run()
        phase("timing_of_phase", which=name, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()

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
