"""The port's FR command-line tools against the JAX package's on the CPU,
on the same synthetic tree with the same VGG weights (the JAX package's
``init_vgg16_params(seed=0)`` written as a ``.npz`` that both read):
``run_fr`` (CV with the stats cache, cross-dataset validation, the image
path under DMOS), ``prep_fr`` (square and full-size policies, DISTS and
ADISTS), ``reeval`` (a reference-layout ``.pth`` and the port's own
checkpoint) and ``quality_demo`` (``--kind fr`` and ``--kind nr`` smokes),
all with ``--device cpu`` and no loader worker processes (forking a
process that runs JAX's threads can deadlock the child); and a
slow-marked copy of the three-seed FR quality certificate. The quality_demo
smokes hold the port's tool to the JAX package's: the same training call,
and the same summary (``--kind fr`` from each package's own training on
the same VGG weights, ``--kind nr`` from each tool reading the same run)."""
import csv
import functools
import json
import os

import numpy as np
import pytest
import torch

from nerf_qa_torch.compat.from_jax import vgg_state_dict_from_jax
from nerf_qa_torch.compat.pretrained import ENV_VGG
from nerf_qa_torch.data.factories import create_test2_dataloader
from nerf_qa_torch.tools import prep_fr as tprep
from nerf_qa_torch.tools import quality_demo as tqd
from nerf_qa_torch.tools import reeval as treeval
from nerf_qa_torch.tools import run_fr as trun
from nerf_qa_torch.tools import train_nr as ttrain_nr
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.tools import prep_fr as jprep
from nerf_qa_tpu.tools import quality_demo as jqd
from nerf_qa_tpu.tools import reeval as jreeval
from nerf_qa_tpu.tools import run_fr as jrun
from nerf_qa_tpu.tools import train_nr as jtrain_nr
from nerf_qa_tpu.tools.make_synthetic_dataset import make_fr_tree
from tests.torch_parity import jax_params, np_params, one_torch_thread  # noqa: F401

# per-video DISTS through each package's own pyramid: the score bar of
# tests/test_torch_dists.py (the port's kernel route takes the one-pass
# moments on the CPU, JAX the two-pass)
SCORE_ATOL = 1e-4
# per-video predictions after a short training run at lr 1e-3: Adam moves a
# channel by ~lr·sign(g), so where an α/β gradient is near zero the two
# packages' updates differ (tests/test_torch_fr_train.py), and the head
# carries the score differences (measured: 8.2e-4 after two epochs; the
# held-out DISTS 1.2e-5)
PRED_ATOL = 2e-3
# the target column as each package parses the CSV: pandas' float parser
# may land an ulp away from Python's
MOS_RTOL = 1e-15
# prep_fr: DISTS and ADISTS per frame in fp32 (tests/test_torch_adists_cli.py)
PREP_ATOL = 1e-4


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _cols(rows, key):
    return np.array([float(r[key]) for r in rows])


@pytest.fixture(scope="module")
def tree(tmp_path_factory, np_params):
    root = tmp_path_factory.mktemp("fr_cli")
    data = str(root / "data")
    scores = make_fr_tree(data, scenes=("lego", "truck", "ship", "room"),
                          methods_per_scene=2, frames=2, hw=(48, 64), seed=1,
                          dists_col=False)
    vgg = str(root / "vgg.npz")
    export_vgg16_to_npz(np_params, vgg)
    return root, data, scores, vgg


@pytest.fixture
def in_process_loaders(monkeypatch):
    """The port's tools with loaders that fork no workers. reeval's loader
    takes the factory's default count and quality_demo hands its trainers a
    fixed one, as the JAX tools do; here each becomes 0. Returns the argv
    each trainer CLI got from quality_demo, before that change."""
    seen = {}

    def wrap(module, name):
        real = module.main

        def main(argv):
            seen[name] = list(argv)
            i = argv.index("--num-workers")
            return real([*argv[:i + 1], "0", *argv[i + 2:]])

        monkeypatch.setattr(module, "main", main)

    wrap(trun, "run_fr")
    wrap(ttrain_nr, "train_nr")
    monkeypatch.setattr(treeval, "create_test2_dataloader",
                        functools.partial(create_test2_dataloader, num_workers=0))
    return seen


def _run_both(tree, name, extra, scores=None):
    root, data, tree_scores, vgg = tree
    scores = scores or tree_scores
    common = ["--data-dir", data, "--scores-csv", scores, "--vgg-ckpt", vgg,
              "--batch-size", "4", "--num-workers", "0", "--lr", "1e-3"] + extra
    out = {}
    for pkg, main, more in (("jax", jrun.main, []),
                            ("port", trun.main, ["--device", "cpu"])):
        out[pkg] = str(root / f"{name}_{pkg}")
        main(common + ["--output-dir", out[pkg]] + more)
    return out


def _artifacts(d):
    return sorted(f for f in os.listdir(d) if f != "ckpt")


@pytest.fixture(scope="module")
def cached_runs(tree):
    root, data, scores, _ = tree
    # a linear head: a logistic curve_fit on 4 training videos in two
    # clusters is ill-conditioned (per-video scores 6e-7 apart, well
    # within SCORE_ATOL, move its b4 by 13 %); the logistic init is held to
    # JAX on identical inputs in tests/test_torch_fr_model.py
    return _run_both(tree, "cached", [
        "--folds", "2", "--epochs", "2", "--cache-stats",
        "--regression-type", "linear",
        "--val-scores-csv", scores, "--val-data-dir", data])


def test_run_fr_cached_cv_matches_jax(cached_runs):
    port, jax_dir = cached_runs["port"], cached_runs["jax"]
    assert _artifacts(port) == _artifacts(jax_dir) == [
        "config.json", "metrics.jsonl", "regression_0.plotly.json",
        "regression_1.plotly.json", "results_0.csv", "results_1.csv",
        "results_cv.csv", "results_val_0.csv", "results_val_1.csv",
        "results_val_2.csv"]
    with open(os.path.join(port, "results_cv.csv"), "rb") as a, \
            open(os.path.join(jax_dir, "results_cv.csv"), "rb") as b:
        assert a.read() == b.read()
    for name in ("results_0.csv", "results_1.csv", "results_val_2.csv"):
        got, want = _read(os.path.join(port, name)), _read(os.path.join(jax_dir, name))
        assert list(got[0]) == list(want[0]) == ["video_id", "pred_score", "mos",
                                                 "dists_score"]
        assert [r["video_id"] for r in got] == [r["video_id"] for r in want]
        np.testing.assert_allclose(_cols(got, "mos"), _cols(want, "mos"), rtol=MOS_RTOL)
        np.testing.assert_allclose(_cols(got, "dists_score"), _cols(want, "dists_score"),
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(_cols(got, "pred_score"), _cols(want, "pred_score"),
                                   atol=PRED_ATOL)
    # the same log keys, and a checkpoint per fold plus the final one
    with open(os.path.join(port, "metrics.jsonl")) as a, \
            open(os.path.join(jax_dir, "metrics.jsonl")) as b:
        got_keys = [set(json.loads(line)) for line in a]
        want_keys = [set(json.loads(line)) for line in b]
    assert got_keys == want_keys
    assert sorted(os.listdir(os.path.join(port, "ckpt"))) == [
        "FORMAT", "step_00000000", "step_00000001", "step_00000002"]


def test_run_fr_image_path_under_dmos_matches_jax(tree):
    # no cache: every step runs the pyramid; DMOS targets the head init
    # and the test column while the dataset still yields MOS (mirrored);
    # the scene-type calibration and video-stats heads on
    # scene types: real (truck), synthetic (lego, ship), unknown (room);
    # two per-video statistics columns feed the stats head
    root, _, scores, _ = tree
    rows = _read(scores)
    rng = np.random.default_rng(3)
    for r in rows:
        r["DISTS_std"], r["DISTS_min"] = (repr(float(v)) for v in rng.uniform(0, 0.1, 2))
    stats_csv = str(root / "scores_stats.csv")
    with open(stats_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    runs = _run_both(tree, "image", ["--folds", "2", "--epochs", "1",
                                     "--subjective-score-type", "DMOS",
                                     "--regression-type", "linear",
                                     "--scene-type-conditioning",
                                     "--video-stats-cols", "DISTS_std,DISTS_min"],
                     scores=stats_csv)
    for name in ("results_0.csv", "results_1.csv"):
        got = _read(os.path.join(runs["port"], name))
        want = _read(os.path.join(runs["jax"], name))
        np.testing.assert_allclose(_cols(got, "mos"), _cols(want, "mos"), rtol=MOS_RTOL)
        np.testing.assert_allclose(_cols(got, "dists_score"), _cols(want, "dists_score"),
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(_cols(got, "pred_score"), _cols(want, "pred_score"),
                                   atol=PRED_ATOL)


# ADISTS at the frames' own size only: at 256² it takes ~25 s a package
# on the CPU
@pytest.mark.parametrize("policy,metrics", [("square", ("DISTS",)),
                                            ("full_size", ("DISTS", "ADISTS"))])
def test_prep_fr_matches_jax(tree, policy, metrics):
    root, data, scores, vgg = tree
    no_adists = [] if "ADISTS" in metrics else ["--no-adists"]
    out = {}
    for pkg, main, more in (("jax", jprep.main, []),
                            ("port", tprep.main, ["--device", "cpu"])):
        out[pkg] = str(root / f"prep_{policy}_{pkg}.csv")
        main(["--data-dir", data, "--scores-csv", scores, "--policy", policy,
              "--compute-dtype", "float32", "--batch-size", "2", "--vgg-ckpt", vgg,
              "--output-csv", out[pkg]] + more + no_adists)
    got, want = _read(out["port"]), _read(out["jax"])
    assert list(got[0]) == list(want[0])
    for m in metrics:
        for key in (m, f"{m}_std", f"{m}_min", f"{m}_max"):
            np.testing.assert_allclose(_cols(got, key), _cols(want, key),
                                       atol=PREP_ATOL, err_msg=key)
        for g, w in zip(got, want):
            assert g["distorted_folder"] == w["distorted_folder"]
            np.testing.assert_allclose(json.loads(g[f"{m}_frames"]),
                                       json.loads(w[f"{m}_frames"]), atol=PREP_ATOL)


def _reference_pth(path, np_params):
    """A reference FR model.pth (model_stats.py layout): a linear head, the
    fine-tuned α/β and the frozen VGG stages under dists_model.*"""
    rng = np.random.default_rng(0)
    sd = {"dists_weight": torch.tensor([-6.0]), "dists_bias": torch.tensor([5.0]),
          "dists_model.alpha": torch.from_numpy(rng.random((1, 1475, 1, 1), np.float32)),
          "dists_model.beta": torch.from_numpy(rng.random((1, 1475, 1, 1), np.float32))}
    sd.update({f"dists_model.{k}": v for k, v in vgg_state_dict_from_jax(np_params).items()
               if k.startswith("stage") and not k.endswith("filter")})
    torch.save(sd, path)


def test_reeval_reference_pth_matches_jax(tree, np_params, tmp_path,
                                          in_process_loaders):
    _, data, scores, _ = tree
    pth = str(tmp_path / "model.pth")
    _reference_pth(pth, np_params)
    out = {}
    for pkg, main, more in (("jax", jreeval.main, []),
                            ("port", treeval.main, ["--device", "cpu"])):
        out[pkg] = str(tmp_path / f"reeval_{pkg}.csv")
        main(["--checkpoint", pth, "--data-dir", data, "--scores-csv", scores,
              "--regression-type", "linear", "--compute-dtype", "float32",
              "--batch-size", "4", "--output-csv", out[pkg]] + more)
    got, want = _read(out["port"]), _read(out["jax"])
    assert [r["video_id"] for r in got] == [r["video_id"] for r in want]
    np.testing.assert_allclose(_cols(got, "dists_score"), _cols(want, "dists_score"),
                               atol=SCORE_ATOL)
    # slope -6 head
    np.testing.assert_allclose(_cols(got, "pred_score"), _cols(want, "pred_score"),
                               atol=6 * SCORE_ATOL)


def test_reeval_reads_the_ports_checkpoint(cached_runs, tree, tmp_path, capsys,
                                           in_process_loaders):
    _, data, scores, vgg = tree
    out = str(tmp_path / "reeval.csv")
    treeval.main(["--checkpoint", os.path.join(cached_runs["port"], "ckpt"),
                  "--data-dir", data, "--scores-csv", scores, "--vgg-ckpt", vgg,
                  "--compute-dtype", "float32", "--batch-size", "4",
                  "--regression-type", "linear",
                  "--device", "cpu", "--output-csv", out])
    got = _read(out)
    assert len(got) == 8 and np.isfinite(_cols(got, "pred_score")).all()
    # the final full-data fold's params score the validation pass the run
    # itself wrote (the same rows, the same pyramid)
    val = _read(os.path.join(cached_runs["port"], "results_val_2.csv"))
    np.testing.assert_allclose(_cols(got, "pred_score"), _cols(val, "pred_score"),
                               rtol=0, atol=1e-5)
    assert "correlations:" in capsys.readouterr().out


# the JAX package's smoke settings (tests/test_quality_demo.py:15-26)
QD_FR_SMOKE = ["--kind", "fr", "--epochs", "1", "--folds", "2", "--scenes", "4",
               "--methods", "2", "--frames", "2", "--batch-size", "4"]
# the smoke's cross-validated PLCC, each package training on its own: its
# logistic fit on 4 videos a fold is degenerate (curve_fit cannot estimate
# the covariance), a near-step head that turns score gaps of 1e-6 into
# prediction gaps of up to 9e-3 (measured) while the 8 predictions spread
# by σ = 0.63. PLCC moves by about ‖Δpred‖ / (√8 · σ) ≈ 6e-3 (measured
# 1.9e-3). SRCC and KTCC only move where two predictions swap order,
# which they do not
QD_PLCC_ATOL = 1e-2


def test_quality_demo_fr_smoke_matches_jax_layout(tree, tmp_path, monkeypatch, capsys,
                                                  in_process_loaders):
    # both packages' tools on their own identical trees (make_fr_tree, seed
    # 0) with the same VGG weights, each training through its own run_fr
    seen = in_process_loaders
    monkeypatch.setenv(ENV_VGG, tree[3])
    real = jrun.main

    def jax_run_fr(argv):
        seen["jax_run_fr"] = list(argv)
        return real(argv)

    monkeypatch.setattr(jrun, "main", jax_run_fr)
    out = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    want = jqd.main(QD_FR_SMOKE + ["--out", out["jax"]])
    got = tqd.main(QD_FR_SMOKE + ["--out", out["port"], "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    # the same run_fr call, paths aside
    assert ([a.replace(out["port"], "OUT") for a in seen["run_fr"]]
            == [a.replace(out["jax"], "OUT") for a in seen["jax_run_fr"]]
            + ["--device", "cpu"])
    assert got["n_videos"] == want["n_videos"] == 8
    assert (got["cv_srcc"], got["cv_ktcc"]) == (want["cv_srcc"], want["cv_ktcc"])
    assert abs(got["cv_plcc"] - want["cv_plcc"]) <= QD_PLCC_ATOL, (got, want)
    for fold in (0, 1):  # the same videos held out in each fold
        name = os.path.join("run", f"results_{fold}.csv")
        g = _read(os.path.join(out["port"], name))
        w = _read(os.path.join(out["jax"], name))
        assert [r["video_id"] for r in g] == [r["video_id"] for r in w]
        np.testing.assert_allclose(_cols(g, "mos"), _cols(w, "mos"), rtol=MOS_RTOL)
    # the JAX tool's reading of the port's run (its run_fr replaced by a
    # call that does nothing): the fold files it picks and what it makes of
    # them are the port's, exactly
    monkeypatch.setattr(jrun, "main", lambda argv: 0)
    assert jqd.main(QD_FR_SMOKE + ["--out", out["port"]]) == got


def test_quality_demo_nr_smoke(tmp_path, monkeypatch, in_process_loaders):
    # the port's tool trains through its own train_nr; then the JAX tool
    # runs on the same directory with its train_nr replaced by a call that
    # only records its argv, so it reads the port's metrics.jsonl
    seen = in_process_loaders
    args = ["--kind", "nr", "--out", str(tmp_path / "q"), "--epochs", "1",
            "--scenes", "4", "--methods", "2", "--frames", "2",
            "--render-size", "32", "--sem-size", "28", "--vit-depth", "1"]
    got = tqd.main(args + ["--device", "cpu"])
    assert got["n_videos"] == 2
    assert len(got["train_combined"]) == 1 and 0 <= got["val_l1"] < float("inf"), got
    monkeypatch.setattr(jtrain_nr, "main",
                        lambda argv: seen.__setitem__("jax_train_nr", list(argv)))
    assert jqd.main(args) == got
    assert seen["train_nr"] == seen["jax_train_nr"] + ["--device", "cpu"]


def test_cli_needs_a_gpu_unless_asked(tree, tmp_path, monkeypatch):
    _, data, scores, _ = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--data-dir", data, "--scores-csv", scores,
                   "--output-dir", str(tmp_path / "r")])


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fr_quality_certificate(tmp_path, seed, in_process_loaders):
    """The JAX package's three-seed FR certificate
    (tests/test_quality_demo.py:29-49), through the port on the CPU: 40
    videos, 4-fold scene-grouped CV through run_fr with the stats cache, at
    the same thresholds."""
    res = tqd.main([
        "--kind", "fr", "--out", str(tmp_path / "q"),
        "--epochs", "5", "--folds", "4", "--scenes", "8", "--methods", "5",
        "--frames", "2", "--batch-size", "16", "--seed", str(seed),
        "--device", "cpu",
    ])
    assert res["n_videos"] == 40
    assert res["cv_plcc"] >= 0.90, (seed, res)
    assert res["cv_srcc"] >= 0.80, (seed, res)
    assert res["cv_ktcc"] >= 0.60, (seed, res)
