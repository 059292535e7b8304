"""NR trainer CLI (train-nr.py), on the GPU.

Counterpart of ``nerf_qa_tpu/tools/train_nr.py``. Reference behaviour:
train-nr.py — argparse (:180-203: vit_model, refine scales, dropout, aug
params, dists_pref2ref_coeff, ...), scene-holdout val split + method
blacklist (:231-244), per-epoch training with loss aggregation, and a
validation pass every ``--test-every`` epochs that scores whole videos
(mean frame score) and correlates them with the per-frame DISTS means,
and with ``--test-scores-csv`` / ``--test-data-dir`` the NeRF-QA benchmark
pass (``eval/nr_benchmark.py``: PLCC/SRCC/KTCC against MOS and DMOS for
syn/tnt/all, logged as ``Test Metrics Dict/{subset}/{target}/{metric}``).

It takes the JAX CLI's flags plus ``--device`` (the GPU by default; it
never carries on on the CPU unless asked): ``--version`` 1-8, ``--mode
score-map`` (the score-map objective on ``tools/prep_nr.py --score-maps``
trees), ``--remat``, and ``--feature-cache`` (ViT tokens from
``tools/cache_nr_features.py``; it turns the random augmentations off).
Under a cluster's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID`` (``parallel.distributed.maybe_initialize``) each process
reads only its slice of the sampler's order (``HostShardedSampler``), as
the JAX tool's processes do.
Checkpoints go to ``<output-dir>/ckpt/step_<epoch>``
(``compat/checkpoint.py``); the final one scores with ``python -m
nerf_qa_torch.tools.score --nr --nr-ckpt <output-dir>/ckpt
[--nr-version N]``. ``--init-from`` takes a port checkpoint directory or a
reference-layout v7/v8 NR ``.pth``, with its α/β; a JAX orbax directory
exits (reading orbax needs JAX: ROADMAP Queue 1, "Not to port").

Usage:
  python -m nerf_qa_torch.tools.train_nr --data-dir <NeRF-NR-QA root> \\
      --scores-csv output.csv --epochs 50 ...
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from nerf_qa_torch.compat.checkpoint import (
    PreemptionSaver,
    restore_checkpoint,
    save_checkpoint,
)
from nerf_qa_torch.compat.pretrained import (
    add_backbone_args,
    load_nr_torch_file,
    resolve_dists_weights,
    resolve_jbu_params,
    resolve_vgg_params,
    resolve_vit_params,
)
from nerf_qa_torch.config import DISTSConfig, NRModelConfig, TrainConfig, resolve_device
from nerf_qa_torch.core.dists import weights_from_arrays
from nerf_qa_torch.data.factories import create_nr_dataloader
from nerf_qa_torch.data.feature_cache import TokenCacheReader
from nerf_qa_torch.data.pipeline import device_prefetch
from nerf_qa_torch.parallel.distributed import host_info, maybe_initialize
from nerf_qa_torch.eval.correlations import compute_correlations
from nerf_qa_torch.eval.nr_benchmark import benchmark_report, score_benchmark_videos
from nerf_qa_torch.logging.metrics import MetricAggregator, jsonl_sink, log_artifact
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.train.nr_train import NRTrainer, scene_holdout_split


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NR NeRF-QA trainer")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    # model (train-nr.py:180-203)
    p.add_argument("--vit-model", default="dinov2",
                   choices=["dinov2", "dino16", "clip", "vit"])
    p.add_argument("--vit-depth", type=int, default=12,
                   help="semantic backbone depth (12 = ViT-S; lower for "
                        "ablations/smoke runs)")
    p.add_argument("--version", type=int, default=8, choices=range(1, 9))
    p.add_argument("--refine-up-depth", type=int, default=2)
    p.add_argument("--transformer-decoder-depth", type=int, default=2)
    p.add_argument("--dropout-rate", type=float, default=0.2)
    p.add_argument("--refine-scale1", type=float, default=1.0)
    p.add_argument("--refine-scale2", type=float, default=0.1)
    p.add_argument("--refine-scale3", type=float, default=0.1)
    p.add_argument("--refine-scale4", type=float, default=0.1)
    p.add_argument("--dists-pref2ref-coeff", type=float, default=0.5)
    # augmentation
    p.add_argument("--aug-crop-scale", type=float, default=0.8)
    p.add_argument("--aug-rot-deg", type=float, default=30.0)
    # data / IO
    p.add_argument("--data-dir", required=True)
    p.add_argument("--scores-csv", required=True)
    p.add_argument("--mode", default="gt", choices=["gt", "score-map"],
                   help="gt: self-supervised DISTS objective (train-nr.py); "
                        "score-map: additionally supervise the predicted "
                        "ADISTS map against prep_nr's -log10 score maps "
                        "(nerf_nr_qa_prep_4.py:101-135)")
    p.add_argument("--score-map-coeff", type=float, default=1.0)
    p.add_argument("--feature-cache", default=None,
                   help="ViT-token cache root from tools/cache_nr_features: "
                        "train/val steps skip the frozen ViT forward. Forces "
                        "augs off (tokens are cached for the canonical "
                        "frames); mode 'gt' only.")
    p.add_argument("--holdout-scenes", nargs="*", default=[])
    p.add_argument("--blacklist-methods", nargs="*", default=[])
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--output-dir", default="./nr_runs")
    p.add_argument("--test-every", type=int, default=5)
    # NeRF-QA video-level benchmark (train-nr.py:299-375): every
    # --test-every epochs score whole benchmark videos and report
    # PLCC/SRCC/KTCC vs MOS and DMOS for syn/tnt/all subsets
    p.add_argument("--test-scores-csv", default=None,
                   help="NeRF-QA benchmark CSV (reference_filename, "
                        "distorted_filename, MOS, DMOS[, DISTS])")
    p.add_argument("--test-data-dir", default=None,
                   help="benchmark video root: frame directories named after "
                        "each video")
    p.add_argument("--test-max-frames", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from", default=None,
                   help="port checkpoint directory or reference-layout NR "
                        ".pth to initialize the decoder (and the DISTS α/β "
                        "it carries) from, with a fresh optimizer")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--decoder-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="decoder conv/attention compute dtype (params and "
                        "optimizer state stay fp32)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each v7/v8 RefineUp stage (activation "
                        "memory -> larger batches)")
    p.add_argument("--render-size", type=int, default=256,
                   help="DISTS input side; must satisfy "
                        "render_size/16 == sem_size/14")
    p.add_argument("--sem-size", type=int, default=224)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    return p


def read_rows(path: str) -> list[dict]:
    """The scores CSV as a list of dicts (string values)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _validate(trainer: NRTrainer, rows, args, agg: MetricAggregator, epoch: int,
              tokens: TokenCacheReader | None = None):
    """Video-level scores (mean frame score) against the per-frame DISTS
    means (train-nr.py:299-315)."""
    loader = create_nr_dataloader(
        rows, args.data_dir, mode="gt", is_train=False,
        batch_size=args.batch_size, num_workers=args.num_workers,
        render_size=args.render_size, sem_size=args.sem_size)
    preds, targets = {}, {}
    for batch in loader:
        _, render, _, dists_mean, vid, frame = batch[:6]
        toks = None if tokens is None else tokens.gather(vid, frame)
        scores = trainer.score_frames(render["256x256"], render["224x224"], toks)
        for v, s, t in zip(np.asarray(vid), scores, np.asarray(dists_mean)):
            preds.setdefault(int(v), []).append(float(s))
            targets.setdefault(int(v), []).append(float(t))
    vp = np.array([np.mean(preds[v]) for v in sorted(preds)])
    vt = np.array([np.mean(targets[v]) for v in sorted(targets)])
    agg.add({"l1": float(np.abs(vp - vt).mean())})
    if len(vp) > 1:
        agg.add(compute_correlations(vp, vt))
    print("val:", agg.log_summary(epoch))


def _benchmark(trainer: NRTrainer, args, sink, epoch: int) -> None:
    """The NeRF-QA benchmark pass (train-nr.py:299-375)."""
    rows = read_rows(args.test_scores_csv)
    scores = score_benchmark_videos(
        lambda a, b: trainer.score_video(a, b, args.batch_size), rows,
        args.test_data_dir, args.test_max_frames, args.render_size, args.sem_size)
    report = benchmark_report(rows, scores)
    sink({f"Test Metrics Dict/{k}": v for k, v in report.items()}, epoch)
    print("test:", {k: round(v, 4) for k, v in report.items()})


def _token_readers(args, train_rows, val_rows):
    """The token caches of the train and validation rows (None without
    ``--feature-cache``); turns the random augmentations off."""
    if not args.feature_cache:
        return None, None
    if args.mode != "gt":
        raise SystemExit("--feature-cache requires --mode gt")
    if args.aug_rot_deg or args.aug_crop_scale != 1.0:
        print("feature cache: disabling random augs (tokens are cached for "
              "the canonical frames)")
        args.aug_rot_deg, args.aug_crop_scale = 0.0, 1.0
    train_tokens = TokenCacheReader(args.feature_cache, train_rows)
    got, total = train_tokens.coverage()
    if got < total:
        raise SystemExit(f"feature cache incomplete: {got}/{total} train videos "
                         "cached — run tools/cache_nr_features first")
    return train_tokens, TokenCacheReader(args.feature_cache, val_rows) if val_rows else None


def _train_batch(trainer: NRTrainer, batch, mode: str,
                 tokens: TokenCacheReader | None) -> dict:
    """One step on a loader batch: (gt, render, score_map, vid, frame) in
    score-map mode, (gt, render, std, mean, vid, frame) otherwise."""
    gt, render = batch[0], batch[1]
    if mode == "score-map":
        return trainer.train_step_score_map(gt, render["256x256"], render["224x224"],
                                            batch[2])
    toks = None
    if tokens is not None:
        toks = tokens.gather(batch[4].cpu().numpy(), batch[5].cpu().numpy())
    return trainer.train_step(gt, render["256x256"], render["224x224"], batch[2],
                              batch[3], sem_tokens=toks)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # multi-process: nothing without a coordinator; with one, each process
    # decodes only its slice of the frame stream
    distributed = maybe_initialize()
    os.makedirs(args.output_dir, exist_ok=True)
    sink = jsonl_sink(os.path.join(args.output_dir, "metrics.jsonl"))

    rows = read_rows(args.scores_csv)
    train_mask, val_mask = scene_holdout_split(
        [r["scene"] for r in rows], args.holdout_scenes,
        [r["method"] for r in rows] if rows and "method" in rows[0] else None,
        args.blacklist_methods)
    train_rows = [r for r, m in zip(rows, train_mask) if m]
    val_rows = [r for r, m in zip(rows, val_mask) if m]
    print(f"train videos: {len(train_rows)}  val videos: {len(val_rows)}")
    train_tokens, val_tokens = _token_readers(args, train_rows, val_rows)

    cfg = NRModelConfig(
        version=args.version,
        vit_model=args.vit_model,
        refine_up_depth=args.refine_up_depth,
        transformer_decoder_depth=args.transformer_decoder_depth,
        dropout_rate=args.dropout_rate,
        refine_scale1=args.refine_scale1,
        refine_scale2=args.refine_scale2,
        refine_scale3=args.refine_scale3,
        refine_scale4=args.refine_scale4,
        dists_pref2ref_coeff=args.dists_pref2ref_coeff,
        score_map_coeff=args.score_map_coeff,
        decoder_dtype=args.decoder_dtype,
        remat=args.remat,
        dists=DISTSConfig(compute_dtype=args.compute_dtype),
    )
    vit = resolve_vit_params(args.vit_ckpt, depth=args.vit_depth,
                             grid_size=args.sem_size // 14, seed=args.seed)
    model = NRModel(
        resolve_vgg_params(args.vgg_ckpt, seed=args.seed),
        resolve_dists_weights(cfg.dists, args.dists_weights), cfg, vit=vit,
        jbu=(resolve_jbu_params(args.jbu_ckpt, dim=vit.embed_dim)
             if args.version >= 7 else None),
        render_size=args.render_size, sem_size=args.sem_size)
    train_cfg = TrainConfig(
        lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        epochs=args.epochs, batch_size=args.batch_size,
        schedule="constant", seed=args.seed)
    loader = create_nr_dataloader(
        train_rows, args.data_dir, mode=args.mode, is_train=True,
        batch_size=args.batch_size, num_workers=args.num_workers,
        seed=args.seed, aug_crop_scale=args.aug_crop_scale,
        aug_rot_deg=args.aug_rot_deg,
        render_size=args.render_size, sem_size=args.sem_size,
        host_sharded=distributed)
    if distributed:
        hid, hcount = host_info()
        print(f"multi-host: process {hid}/{hcount}")
    trainer = NRTrainer(model, train_cfg, steps_per_epoch=max(1, len(loader)),
                        device=device)
    trainer.init()

    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    start_epoch = 0
    if args.init_from:
        try:
            decoder_sd, alpha_beta = load_nr_torch_file(args.init_from)
        except ValueError as e:
            raise SystemExit(str(e)) from e
        trainer.set_decoder(NRDecoder.from_state_dict(decoder_sd, cfg, vit.embed_dim))
        if alpha_beta is not None:
            # fine-tuned metric weights imported alongside the decoder:
            # train against them, not the bundled ones
            w = weights_from_arrays(*alpha_beta, cfg.dists)
            with torch.no_grad():
                model.alpha.copy_(w.alpha)
                model.beta.copy_(w.beta)
            print("using the checkpoint's fine-tuned DISTS alpha/beta")
        print(f"initialized decoder params from {args.init_from}")
    if args.resume:
        restored = restore_checkpoint(ckpt_dir)
        if restored:
            _, state = restored
            trainer.load_state_dict(state)
            start_epoch = int(state["epoch"])
            print(f"resumed from epoch {start_epoch}")
    saver = PreemptionSaver(ckpt_dir)

    agg = MetricAggregator("Train Metrics Dict", log_fn=sink)
    val_agg = MetricAggregator("Validation Metrics Dict", log_fn=sink)
    for epoch in range(start_epoch, args.epochs):
        loader.sampler.set_epoch(epoch)
        t0, frames = time.perf_counter(), 0
        # double-buffered H2D: pinned copies on a side stream, a batch
        # ahead of the step that reads it
        for batch in device_prefetch(loader, device=device):
            losses = _train_batch(trainer, batch, args.mode, train_tokens)
            agg.add({k: float(v) for k, v in losses.items()})
            frames += batch[0].shape[0]
        logs = agg.log_summary(epoch)
        rate = frames / max(time.perf_counter() - t0, 1e-9)
        print(f"epoch {epoch}: {logs}  ({rate:.1f} fr/s on {device})")
        state = dict(trainer.state_dict(), epoch=epoch + 1)
        if args.checkpoint_every and (epoch + 1) % args.checkpoint_every == 0:
            save_checkpoint(ckpt_dir, epoch + 1, state)
        saver.maybe_save(epoch + 1, state)
        if val_rows and (epoch + 1) % args.test_every == 0:
            _validate(trainer, val_rows, args, val_agg, epoch, val_tokens)
        if (args.test_scores_csv and args.test_data_dir
                and (epoch + 1) % args.test_every == 0):
            _benchmark(trainer, args, sink, epoch)

    final_path = save_checkpoint(ckpt_dir, args.epochs,
                                 dict(trainer.state_dict(), epoch=args.epochs))
    # run_final.py:328-336-style model Artifact upload (no-op sans wandb)
    log_artifact(final_path, name="nr_model", type="model")
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
