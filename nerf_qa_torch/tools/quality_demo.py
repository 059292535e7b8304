"""End-to-end quality-recovery demonstration on synthetic data, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/quality_demo.py``. The reference's
headline numbers are MOS correlations obtained with pretrained backbones;
without those checkpoints (no downloads) this tool is the substitute: it
builds a synthetic Test2-layout dataset whose MOS is a noisy monotone
function of the injected distortion strength
(tools/make_synthetic_dataset.py), trains the FR model through the real
training path (tools/run_fr.py — GroupKFold CV, logistic head, stats cache,
metric logger) and reports held-out cross-validated PLCC/SRCC/KTCC. High
recovered correlations certify the whole train->score->aggregate->
correlate stack; with real checkpoints the same command on real datasets
reproduces the reference recipe (run_final.py:231-344).

``--kind nr`` is the analogous certificate for the no-reference stack: a
synthetic NeRF-NR-QA tree whose per-method distortion strength (and
DISTS_mean target) rises monotonically, trained through
tools/train_nr.py (scene-holdout split, self-supervised DISTS objective,
val correlation loop, train-nr.py:270-377), reporting the held-out-scene
video-level PLCC/SRCC against the targets.

Usage:
  python -m nerf_qa_torch.tools.quality_demo --out /tmp/qdemo [--epochs 8]
  python -m nerf_qa_torch.tools.quality_demo --kind nr --out /tmp/qdemo_nr
  (add --device cpu to run on the host)

Prints ONE JSON line:
  fr: {"cv_plcc": ..., "cv_srcc": ..., "cv_ktcc": ..., "n_videos": ...}
  nr: {"val_plcc": ..., "val_srcc": ..., "val_l1": ..., "n_videos": ...}
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np


def _nr_demo(args) -> dict:
    from nerf_qa_torch.tools.make_synthetic_dataset import make_nr_tree
    from nerf_qa_torch.tools.train_nr import main as train_nr_main

    data_dir = os.path.join(args.out, "data")
    run_dir = os.path.join(args.out, "run")
    os.makedirs(data_dir, exist_ok=True)
    scenes = tuple(f"scene{i:02d}" for i in range(args.scenes))
    methods = tuple(f"m{i}" for i in range(args.methods))
    csv_path = make_nr_tree(data_dir, scenes=scenes, methods=methods,
                            frames=args.frames, seed=args.seed)
    holdout = list(scenes[: max(1, args.scenes // 4)])
    train_nr_main([
        "--data-dir", data_dir, "--scores-csv", csv_path,
        "--output-dir", run_dir,
        "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
        "--lr", str(args.lr), "--seed", str(args.seed),
        "--holdout-scenes", *holdout,
        "--test-every", str(args.epochs),  # val pass on the last epoch
        # default small-but-valid geometry (64/16 == 56/14) + shallow ViT;
        # --render-size 256 --sem-size 224 --vit-depth 12 is the
        # production-scale certificate config
        "--render-size", str(args.render_size),
        "--sem-size", str(args.sem_size),
        "--vit-depth", str(args.vit_depth),
        "--compute-dtype", args.compute_dtype,
        "--decoder-dtype", args.decoder_dtype or args.compute_dtype,
        "--num-workers", "2",
        *(["--device", args.device] if args.device else []),
    ])
    val = {}
    train_combined = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if any(k.startswith("Validation") for k in rec):
                val = rec
            if "Train Metrics Dict/combined" in rec:
                train_combined.append(
                    round(rec["Train Metrics Dict/combined"], 5))
    out = {
        "val_plcc": abs(round(val.get("Validation Metrics Dict/plcc", 0.0), 4)),
        "val_srcc": abs(round(val.get("Validation Metrics Dict/srcc", 0.0), 4)),
        "val_plcc_signed": round(val.get("Validation Metrics Dict/plcc", 0.0), 4),
        "val_srcc_signed": round(val.get("Validation Metrics Dict/srcc", 0.0), 4),
        "val_l1": round(val.get("Validation Metrics Dict/l1", -1.0), 4),
        "train_combined": train_combined,  # per-epoch mean combined loss
        "n_videos": len(holdout) * args.methods,
    }
    print(json.dumps(out))
    return out


def _fr_demo(args) -> dict:
    from nerf_qa_torch.eval.correlations import compute_correlations
    from nerf_qa_torch.tools.make_synthetic_dataset import make_fr_tree
    from nerf_qa_torch.tools.run_fr import main as run_fr_main

    data_dir = os.path.join(args.out, "data")
    run_dir = os.path.join(args.out, "run")
    os.makedirs(data_dir, exist_ok=True)
    scenes = tuple(f"scene{i:02d}" for i in range(args.scenes))
    # dists_col=False: head init must come from REAL metric scores — a
    # logistic head fit to a fabricated DISTS scale saturates on the
    # actual score range and stalls training (see make_fr_tree)
    csv_path = make_fr_tree(data_dir, scenes=scenes,
                            methods_per_scene=args.methods, frames=args.frames,
                            seed=args.seed, dists_col=False)
    run_fr_main([
        "--data-dir", data_dir, "--scores-csv", csv_path,
        "--output-dir", run_dir,
        "--epochs", str(args.epochs), "--folds", str(args.folds),
        "--lr", str(args.lr), "--batch-size", str(args.batch_size),
        "--seed", str(args.seed),
        "--regression-type", "logistic",
        "--compute-dtype", args.compute_dtype,
        "--cache-stats",  # frozen-VGG stats cached once per fold
        "--num-workers", "2",
        *(["--device", args.device] if args.device else []),
    ])
    # held-out predictions: fold files only (results_{folds}.csv is the
    # final full-data train with an empty test split, so it never exists)
    pred, mos = [], []
    for f in sorted(glob.glob(os.path.join(run_dir, "results_[0-9]*.csv"))):
        fold = int(os.path.splitext(f)[0].rsplit("_", 1)[1])
        if fold < args.folds:
            with open(f, newline="") as fh:
                for row in csv.DictReader(fh):
                    pred.append(float(row["pred_score"]))
                    mos.append(float(row["mos"]))
    corr = compute_correlations(np.asarray(pred, np.float64),
                                np.asarray(mos, np.float64))
    out = {
        "cv_plcc": abs(round(corr["plcc"], 4)),
        "cv_srcc": abs(round(corr["srcc"], 4)),
        "cv_ktcc": abs(round(corr["ktcc"], 4)),
        "n_videos": len(pred),
    }
    print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="synthetic quality recovery demo")
    p.add_argument("--kind", choices=["fr", "nr"], default="fr")
    p.add_argument("--out", required=True, help="work dir (dataset + run)")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--folds", type=int, default=4)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--methods", type=int, default=5)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--compute-dtype", default="float32")
    p.add_argument("--seed", type=int, default=0,
                   help="fixture + trainer seed (multi-seed certificates)")
    # NR geometry knobs: defaults = the minutes-scale CPU certificate;
    # 256/224/12 (+--decoder-dtype bfloat16) = the production-scale one
    p.add_argument("--render-size", type=int, default=64)
    p.add_argument("--sem-size", type=int, default=56)
    p.add_argument("--vit-depth", type=int, default=2)
    p.add_argument("--decoder-dtype", default=None,
                   help="NR decoder dtype (default: --compute-dtype)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    args = p.parse_args(argv)

    if args.kind == "nr":
        if args.batch_size == 16:  # NR device batch default (settings.py)
            args.batch_size = 4
        return _nr_demo(args)
    return _fr_demo(args)


if __name__ == "__main__":
    main()
