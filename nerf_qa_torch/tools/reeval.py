"""Re-evaluate a trained FR model checkpoint on a dataset, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/reeval.py``. Reference behavior:
reeval.py — load a saved model (torch.load 'model_fin.pth', reeval.py:83),
score every test video, write results_reeval.csv. Accepts the port's own
checkpoints (``tools/run_fr.py``'s ``ckpt`` directory, latest step) or a
reference torch ``model.pth``, whose
embedded VGG stages it scores with. A JAX orbax checkpoint raises: reading
orbax needs JAX, so it is not ported (ROADMAP Queue 1, "Not to port").

Usage:
  python -m nerf_qa_torch.tools.reeval --checkpoint run/ckpt \\
      --data-dir <Test2 root> --scores-csv scores.csv [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from nerf_qa_torch.compat import checkpoint
from nerf_qa_torch.compat.pretrained import add_backbone_args, resolve_vgg_params
from nerf_qa_torch.config import FRModelConfig, resolve_device
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.data.factories import create_test2_dataloader
from nerf_qa_torch.logging.metrics import MetricCollectionLogger
from nerf_qa_torch.models.fr import params_from_state
from nerf_qa_torch.tools.run_fr import label_scene_types, read_rows
from nerf_qa_torch.train.fr_train import FRTrainer


def load_params(path: str, cfg: FRModelConfig):
    """(params, embedded VGG state_dict|None) from a port checkpoint
    directory or a torch model.pth — the .pth also carries the frozen VGG
    stages (dists_model.stageK.*, DISTS_pt.py:31-49), recovered so the
    re-evaluation runs the exact pyramid the model was trained with."""
    if path.endswith((".pth", ".pt")):
        flat, ab, vgg = checkpoint.convert_fr_model_from_torch(path)
        head = {k.split(".")[1]: torch.from_numpy(v) for k, v in flat.items()
                if k.startswith("head.")}
        w = dists.load_pretrained_weights(cfg.dists)
        if ab is not None:
            w = dists.DISTSWeights(torch.from_numpy(ab["alpha"]),
                                   torch.from_numpy(ab["beta"]))
        return {"head": head, "dists": w}, vgg
    restored = checkpoint.restore_checkpoint(path)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    _, state = restored
    return params_from_state(state["params"]), None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Re-evaluate an FR checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--scores-csv", required=True)
    p.add_argument("--regression-type", default="logistic")
    p.add_argument("--subjective-score-type", default="MOS")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output-csv", default="results_reeval.csv")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    add_backbone_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = FRModelConfig(
        regression_type=args.regression_type,
        subjective_score_type=args.subjective_score_type,
    )
    cfg = cfg.replace(dists=cfg.dists.replace(compute_dtype=args.compute_dtype))
    params, embedded_vgg = load_params(args.checkpoint, cfg)
    rows = label_scene_types(read_rows(args.scores_csv))
    # an explicit --vgg-ckpt wins; otherwise prefer the pyramid embedded
    # in the torch model itself
    if args.vgg_ckpt or embedded_vgg is None:
        vgg = resolve_vgg_params(args.vgg_ckpt, seed=0)
    else:
        vgg = VGG16Pyramid()
        vgg.load_state_dict(embedded_vgg, strict=True)
    trainer = FRTrainer(vgg, cfg, device=device)
    params = trainer.to_device(params)
    loader = create_test2_dataloader(rows, args.data_dir,
                                     batch_size=args.batch_size,
                                     scene_balanced=False)
    result = trainer.score_dataloader(params, iter(loader))
    logger = MetricCollectionLogger("Reeval Metrics Dict")
    for vid, pred in result["pred_score"].items():
        row = rows[int(vid)]
        logger.add_entries(
            {"pred_score": pred, "mos": float(row[args.subjective_score_type]),
             "dists_score": result["dists_score"][vid]},
            video_ids=int(vid), scene_ids=row["scene"],
        )
    logger.write_video_metrics_csv(args.output_csv)
    logs = logger.log_summary(0)
    corr = {k.split("/")[-1]: round(v, 4) for k, v in logs.items()
            if "/correlations/mos/" in k}
    print("correlations:", corr)
    print("wrote", args.output_csv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
