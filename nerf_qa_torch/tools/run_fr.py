"""FR trainer CLI — the canonical experiment script, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/run_fr.py``. Reference behavior:
run_final.py — argparse hyperparameters (:54-75), scene/scene-type
labeling (:77-95), 4-fold GroupKFold-by-scene CV then a final full-data
train (:231-239), per-fold train/test loops with the metric logger, and
artifacts results_{fold}.csv / results.csv / model checkpoints
(:275-344). Variants run.py / run_test2*.py / run_nerf_qa.py are
dataset/objective selections exposed here as --dataset/--val-dataset
flags rather than copied scripts.

It takes the JAX CLI's flags, with ``--stats-impl eager|kernel``
(default ``kernel``: the fused moments kernel on the card, its plain
version on the CPU) and ``--device`` (the GPU by default; it never
carries on on the CPU unless asked). Rows of the scores CSV are plain
dicts (``csv``), where the JAX CLI takes a DataFrame. Artifacts, in
``--output-dir``: results_{fold}.csv, results_cv.csv,
results_val_{fold}.csv, regression_{fold}.plotly.json, metrics.jsonl,
config.json and ckpt/step_{fold}/ (the port's ``save_checkpoint``).

Usage:
  python -m nerf_qa_torch.tools.run_fr --data-dir <Test2 root> \\
      --scores-csv <csv> --lr 1e-4 --epochs 10 [--folds 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
from torch.utils.data import DataLoader

from nerf_qa_torch.compat.checkpoint import save_checkpoint
from nerf_qa_torch.compat.pretrained import (
    add_backbone_args,
    resolve_dists_weights,
    resolve_vgg_params,
)
from nerf_qa_torch.config import (
    DISTSConfig,
    FRModelConfig,
    TrainConfig,
    from_args,
    resolve_device,
)
from nerf_qa_torch.core import dists as dists_core
from nerf_qa_torch.data.factories import (
    create_large_qa_dataloader,
    create_nerf_qa_resize_dataloader,
    create_test2_dataloader,
)
from nerf_qa_torch.data.pipeline import recursive_collate
from nerf_qa_torch.eval.correlations import REAL_SCENE_IDS, SYNTH_SCENE_IDS
from nerf_qa_torch.logging.figures import to_wandb, write_figure_json
from nerf_qa_torch.logging.metrics import (
    MetricCollectionLogger,
    jsonl_sink,
    log_artifact,
)
from nerf_qa_torch.models.fr import params_state
from nerf_qa_torch.train.fr_train import FRTrainer, group_kfold_splits
from nerf_qa_torch.utils.profiling import StepTimer, record_function


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FR NeRF-QA trainer")
    # hyperparameters (run_final.py:54-75)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--schedule", default="exp", choices=["exp", "cosine", "constant"])
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--folds", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    # model config
    p.add_argument("--regression-type", dest="regression_type",
                   default="logistic", choices=["logistic", "sqrt", "linear"])
    p.add_argument("--subjective-score-type", dest="subjective_score_type",
                   default="MOS", choices=["MOS", "DMOS"])
    p.add_argument("--dists-variant", default="original",
                   choices=["main", "original", "softmax"])
    p.add_argument("--dists-weight-norm", dest="weight_norm", default="")
    p.add_argument("--detach-beta", action="store_true")
    p.add_argument("--weight-lower-bound", type=float, default=0.0)
    p.add_argument("--alpha-beta-ratio", type=float, default=1.0)
    p.add_argument("--entropy-loss-coeff", type=float, default=0.0)
    p.add_argument("--project-weights", action="store_true")
    p.add_argument("--head-lr-scale", type=float, default=1.0)
    p.add_argument("--scene-type-conditioning", action="store_true",
                   help="per-scene-type affine calibration of the head "
                        "output (the scene_type= hook of run_test2.py:218)")
    p.add_argument("--video-stats-cols", default="",
                   help="comma-separated CSV columns of per-video DISTS "
                        "statistics fed to the regression head, e.g. "
                        "'DISTS_std,DISTS_min,DISTS_max' "
                        "(run_test2_stats.py:122-135,195)")
    # data / IO
    p.add_argument("--data-dir", required=True)
    p.add_argument("--scores-csv", required=True)
    p.add_argument("--dataset", default="test2",
                   choices=["test2", "nerf-qa-resized", "large"])
    # cross-dataset validation (run_test2.py:165-167 trains on Test2 and
    # validates on Large)
    p.add_argument("--val-dataset", default=None,
                   choices=["test2", "nerf-qa-resized", "large"])
    p.add_argument("--val-data-dir", default=None)
    p.add_argument("--val-scores-csv", default=None)
    p.add_argument("--in-memory", action="store_true")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--output-dir", default="./fr_runs")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--stats-impl", default="kernel", choices=["eager", "kernel"],
                   help="DISTS statistics: the fused moments kernel (its "
                        "plain version for CPU tensors) or the two-pass "
                        "eager oracle")
    p.add_argument("--wandb", action="store_true",
                   help="log to wandb if installed (JSONL sink otherwise)")
    p.add_argument("--grad-accum-steps", type=int, default=0,
                   help="accumulate N micro-batch gradients per step "
                        "(run.py full-epoch accumulation style)")
    p.add_argument("--cache-stats", action="store_true",
                   help="precompute the frozen-VGG DISTS statistics of "
                        "every training pair once, then train α/β + head "
                        "over the cached (5,1475) moments — exact "
                        "gradients, epochs cost ~nothing. Valid for "
                        "deterministic datasets (test2/large); ignored "
                        "with --dataset nerf-qa-resized (random crops "
                        "change the features every epoch). Cached "
                        "moments are always fp32")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    return p


def read_rows(path: str) -> list[dict]:
    """The scores CSV as a list of dicts (string values)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def label_scene_types(rows: list[dict]) -> list[dict]:
    """Scene + scene_type columns (run_final.py:82-95)."""
    out = []
    for row in rows:
        row = dict(row)
        if "scene" not in row:
            src = "reference_folder" if "reference_folder" in row else "reference_filename"
            row["scene"] = os.path.splitext(str(row[src]))[0].replace("_reference", "")
        s = row["scene"]
        row["scene_type"] = ("real" if s in REAL_SCENE_IDS
                             else ("synthetic" if s in SYNTH_SCENE_IDS else "unknown"))
        out.append(row)
    return out


def make_sink(args, run_dir: str):
    if args.wandb:
        try:
            from nerf_qa_torch.logging.metrics import wandb_sink

            return wandb_sink()
        except Exception:
            pass
    return jsonl_sink(os.path.join(run_dir, "metrics.jsonl"))


def make_loader(args, rows, seed: int, dataset: str | None = None,
                data_dir: str | None = None):
    dataset = dataset or args.dataset
    data_dir = data_dir or args.data_dir
    if dataset == "nerf-qa-resized":
        return create_nerf_qa_resize_dataloader(
            rows, data_dir, batch_size=args.batch_size,
            num_workers=args.num_workers, seed=seed,
        )
    if dataset == "large":
        return create_large_qa_dataloader(
            rows, data_dir, batch_size=args.batch_size,
            num_workers=args.num_workers, seed=seed,
        )
    return create_test2_dataloader(
        rows, data_dir, batch_size=args.batch_size,
        in_memory=args.in_memory, num_workers=args.num_workers, seed=seed,
    )


SCENE_TYPE_IDS = {"real": 0, "synthetic": 1, "unknown": 2}


def scene_type_lookup(rows) -> dict[int, int]:
    """{row index (video id): scene-type id} for the calibration head."""
    return {
        i: SCENE_TYPE_IDS.get(str(r["scene_type"]), SCENE_TYPE_IDS["unknown"])
        for i, r in enumerate(rows)
    }


def stats_lookup(rows, cols: list[str]):
    """{row index (video id): per-video stats vector} from CSV columns."""
    return {i: np.asarray([float(r[c]) for c in cols], np.float32)
            for i, r in enumerate(rows)}


def _score_videos(trainer, params, args, rows, loader, stats_cols, name, sink):
    """Per-video scoring of ``rows`` into a fresh logger named ``name``."""
    stats = stats_lookup(rows, stats_cols) if stats_cols else None
    types = scene_type_lookup(rows) if args.scene_type_conditioning else None
    result = trainer.score_dataloader(params, iter(loader), stats_of_video=stats,
                                      scene_type_of_video=types)
    logger = MetricCollectionLogger(name, log_fn=sink)
    for vid, pred in result["pred_score"].items():
        logger.add_entries(
            {
                "pred_score": pred,
                "mos": float(rows[int(vid)][args.subjective_score_type]),
                "dists_score": result["dists_score"][vid],
            },
            video_ids=int(vid),
            scene_ids=rows[int(vid)]["scene"],
        )
    return logger


def run_fold(args, fold: int, train_rows, test_rows, run_dir: str):
    model_cfg = FRModelConfig(
        regression_type=args.regression_type,
        subjective_score_type=args.subjective_score_type,
        dists=DISTSConfig(
            variant=args.dists_variant,
            weight_norm=args.weight_norm,
            detach_beta=args.detach_beta,
            weight_lower_bound=args.weight_lower_bound,
            alpha_beta_ratio=args.alpha_beta_ratio,
            compute_dtype=args.compute_dtype,
            stats_impl=args.stats_impl,
        ),
    )
    train_cfg = from_args(TrainConfig(), vars(args)).replace(
        batch_size=args.batch_size,
        entropy_loss_coeff=args.entropy_loss_coeff,
        project_weights=args.project_weights,
        grad_accum_steps=args.grad_accum_steps,
    )
    stats_cols = [c for c in args.video_stats_cols.split(",") if c]
    train_loader = make_loader(args, train_rows, args.seed)
    steps_per_epoch = max(1, len(train_loader))
    vgg = resolve_vgg_params(args.vgg_ckpt, seed=args.seed)
    dists_weights = resolve_dists_weights(model_cfg.dists, args.dists_weights)
    n_scene_types = len(SCENE_TYPE_IDS) if args.scene_type_conditioning else 0
    trainer = FRTrainer(vgg, model_cfg, train_cfg,
                        steps_per_epoch=steps_per_epoch,
                        head_lr_scale=args.head_lr_scale,
                        dists_weights=dists_weights,
                        n_stats=len(stats_cols),
                        n_scene_types=n_scene_types,
                        device=args.device)
    use_cache = args.cache_stats and args.dataset != "nerf-qa-resized"
    if args.cache_stats and not use_cache:
        print("--cache-stats ignored: nerf-qa-resized re-crops every epoch")
    cache = None
    if use_cache:
        # one sequential frozen-VGG pass over the whole train split;
        # epochs then run on the cached (5,1475) moments
        seq_loader = DataLoader(train_loader.dataset, batch_size=args.batch_size,
                                num_workers=args.num_workers,
                                collate_fn=recursive_collate)
        cache = trainer.build_stats_cache(iter(seq_loader))

    # data-driven head init needs per-video DISTS values; compute them
    # with the pretrained metric when the CSV doesn't carry a DISTS
    # column (prep.py normally writes it)
    if train_rows and "DISTS" in train_rows[0]:
        x = np.asarray([float(r["DISTS"]) for r in train_rows])
    else:
        print("no DISTS column — scoring training videos for head init")
        if cache is not None:
            # chunk over frames: the full (5, N, 1475) fp32 cache plus
            # its elementwise intermediates would not fit at large N
            chunk = max(1, args.batch_size)
            frame_scores = np.concatenate([
                dists_core.score_from_stats(
                    trainer._tensor(cache["stats"][i:i + chunk]).transpose(0, 1),
                    trainer.original_weights, model_cfg.dists,
                ).cpu().numpy()
                for i in range(0, len(cache["stats"]), chunk)
            ])
            per_video = {
                int(v): float(np.mean(frame_scores[cache["video_ids"] == v]))
                for v in np.unique(cache["video_ids"])
            }
        else:
            per_video = trainer.compute_dists_scores(iter(train_loader))
        x = np.asarray([per_video.get(i, np.nan) for i in range(len(train_rows))])
        x = np.where(np.isnan(x), np.nanmean(x), x)
    y = np.asarray([float(r[args.subjective_score_type]) for r in train_rows])
    params, opt_state = trainer.init(x, y)
    train_stats = stats_lookup(train_rows, stats_cols) if stats_cols else None
    train_types = (scene_type_lookup(train_rows)
                   if args.scene_type_conditioning else None)

    sink = make_sink(args, run_dir)
    train_logger = MetricCollectionLogger("Train Metrics Dict", log_fn=sink)
    timer = StepTimer()

    scene_of_video = {i: r["scene"] for i, r in enumerate(train_rows)}
    step = 0
    if use_cache:
        rng = np.random.default_rng(args.seed)
        for epoch in range(args.epochs):
            sampler = train_loader.sampler
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            # flatten defensively: batch samplers yield index LISTS, not
            # scalars
            order = (np.concatenate(
                        [np.atleast_1d(b) for b in sampler]
                     ).astype(np.int64)
                     if sampler is not None
                     else rng.permutation(len(cache["targets"])))
            with record_function("train_epoch"):
                params, opt_state, _ = trainer.train_epoch_cached(
                    params, opt_state, cache, order, args.batch_size,
                    logger=train_logger, scene_of_video=scene_of_video,
                    stats_of_video=train_stats,
                    scene_type_of_video=train_types,
                )
            step += max(1, len(order) // max(1, args.batch_size))
            timer.tick()
            train_logger.log_summary(step)
    for epoch in ([] if use_cache else range(args.epochs)):
        if hasattr(train_loader.sampler, "set_epoch"):
            train_loader.sampler.set_epoch(epoch)
        with record_function("train_epoch"):
            for batch in train_loader:
                dist, ref, score, vid = batch[:4]
                vid = np.asarray(vid)
                stats = None
                if train_stats is not None:
                    stats = np.stack([train_stats[int(v)] for v in vid])
                scene_types = None
                if train_types is not None:
                    scene_types = np.asarray([train_types[int(v)] for v in vid],
                                             np.int32)
                params, opt_state, loss, aux = trainer.train_step(
                    params, opt_state, dist, ref, score, stats=stats,
                    scene_types=scene_types,
                )
                pred = aux[0].cpu().numpy()
                train_logger.add_entries(
                    {
                        "loss": np.full(len(vid), float(loss)),
                        "mse": np.square(pred - np.asarray(score)),
                        "pred_score": pred,
                        "mos": np.asarray(score),
                    },
                    video_ids=vid,
                    scene_ids=np.asarray(
                        [scene_of_video.get(int(v), "?") for v in vid]
                    ),
                )
                timer.tick()
                step += 1
        train_logger.log_summary(step)

    # test: per-video scoring over the held-out fold (run_final.py:132-166)
    if len(test_rows):
        test_logger = _score_videos(
            trainer, params, args, test_rows,
            make_loader(args, test_rows, args.seed), stats_cols,
            "Test Metrics Dict", sink)
        results_path = test_logger.write_video_metrics_csv(
            os.path.join(run_dir, f"results_{fold}.csv"))
        log_artifact(results_path, type="results")
        # per-scene regression figure (logger.py:207): plotly-schema
        # JSON artifact; rendered live only when wandb+plotly exist
        fig = test_logger.per_scene_figure()
        fig_path = write_figure_json(
            fig, os.path.join(run_dir, f"regression_{fold}.plotly.json"))
        log_artifact(fig_path, type="figure")
        wfig = to_wandb(fig)
        if wfig is not None and args.wandb:
            try:
                sink({"Test Metrics Dict/scene_regression": wfig}, step)
            except TypeError:
                pass  # non-wandb sink can't serialize a Plotly object
        test_logger.log_summary(step)

    # cross-dataset validation (run_test2.py:165-167: train Test2,
    # validate Large)
    if args.val_scores_csv and args.val_data_dir:
        val_rows = label_scene_types(read_rows(args.val_scores_csv))
        val_loader = make_loader(args, val_rows, args.seed,
                                 dataset=args.val_dataset or args.dataset,
                                 data_dir=args.val_data_dir)
        val_logger = _score_videos(trainer, params, args, val_rows, val_loader,
                                   stats_cols, "Validation Metrics Dict", sink)
        val_logger.write_video_metrics_csv(
            os.path.join(run_dir, f"results_val_{fold}.csv"))
        val_logger.log_summary(step)
    ckpt_path = save_checkpoint(os.path.join(run_dir, "ckpt"), fold,
                                {"params": params_state(params)})
    # run_final.py:328-336 uploads the saved model as a wandb Artifact
    log_artifact(ckpt_path, name=f"model_{fold}", type="model")
    return params


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.device = str(resolve_device(args.device))
    os.makedirs(args.output_dir, exist_ok=True)
    run_dir = args.output_dir
    rows = label_scene_types(read_rows(args.scores_csv))

    cv_rows = []
    if args.folds > 1:
        for fold, (tr, te) in enumerate(
            group_kfold_splits([r["scene"] for r in rows], args.folds, args.seed)
        ):
            print(f"=== fold {fold}: {len(tr)} train / {len(te)} test videos")
            run_fold(args, fold, [rows[i] for i in tr], [rows[i] for i in te],
                     run_dir)
            cv_rows.append({"fold": fold, "train": len(tr), "test": len(te)})
        with open(os.path.join(run_dir, "results_cv.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["fold", "train", "test"],
                                    lineterminator="\n")
            writer.writeheader()
            writer.writerows(cv_rows)
    # final full-data train (run_final.py's last pass)
    print("=== final full-data train")
    run_fold(args, args.folds, rows, [], run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    print(f"artifacts in {run_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
