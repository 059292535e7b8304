"""The port's NeRF-QA benchmark pass (eval/nr_benchmark.py) against the JAX
package's, on the CPU: the same frame directories and benchmark CSV give
the same frame stacks, per-video scores and report (the same keys, values
to 1e-6); and ``train_nr --test-scores-csv`` logs the report under
``Test Metrics Dict/{subset}/{target}/{metric}``."""
import csv
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from nerf_qa_torch.eval import nr_benchmark as tbench
from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
from nerf_qa_torch.tools import train_nr as ttrain_cli
from nerf_qa_tpu.eval import nr_benchmark as jbench
from tests.torch_parity import one_torch_thread  # noqa: F401

REFS = ["truck_reference.mp4", "playground_reference.mp4", "train_reference.mp4",
        "m60_reference.mp4", "lego_reference.mp4", "drums_reference.mp4",
        "ficus_reference.mp4", "ship_reference.mp4", "room_reference.mp4"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """Nine videos (4 tnt, 4 syn, one in neither) as frame directories,
    three under NeRF-QA_videos/ and the rest at the root, and the CSV."""
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(0)
    rows = []
    for i, ref in enumerate(REFS):
        d = (root / "NeRF-QA_videos" / f"video{i}") if i % 3 == 0 else root / f"video{i}"
        d.mkdir(parents=True)
        for t in range(3):
            img = (rng.random((30, 44, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{t:03d}.png")
        rows.append({"reference_filename": ref, "distorted_filename": f"video{i}.mp4",
                     "MOS": f"{1.0 + 0.5 * i + 0.1 * rng.random():.4f}",
                     "DMOS": f"{8.0 - 0.4 * i + 0.3 * rng.random():.4f}",
                     "DISTS": f"{0.2 + 0.01 * i:.3f}"})
    path = root / "test.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    return str(root), str(path)


def test_subset_names_match_jax():
    assert tbench.TNT_FILES == jbench.TNT_FILES and tbench.SYN_FILES == jbench.SYN_FILES
    assert tbench.TNT_NAMES == jbench.TNT_NAMES and tbench.SYN_NAMES == jbench.SYN_NAMES


@pytest.mark.parametrize("max_frames", [None, 2])
def test_load_render_frames_matches_jax(bench, max_frames):
    root, path = bench
    rows, df = ttrain_cli.read_rows(path), pd.read_csv(path)
    for i in (0, 1, 4):
        got = tbench.load_render_frames(root, rows[i], max_frames, 64, 56)
        want = jbench.load_render_frames(root, df.iloc[i], max_frames, 64, 56)
        assert got[0].shape == (max_frames or 3, 64, 64, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_scores_and_report_match_jax(bench):
    # a deterministic stand-in scorer: the same per-video scores, then the
    # same report keys and values to 1e-6
    root, path = bench
    rows, df = ttrain_cli.read_rows(path), pd.read_csv(path)
    fn = lambda a, b: float(a.mean() - 0.5 * b.std())  # noqa: E731
    got = tbench.score_benchmark_videos(fn, rows, root, None, 64, 56)
    want = jbench.score_benchmark_videos(fn, df, root, None, 64, 56)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    report, want_report = tbench.benchmark_report(rows, got), jbench.benchmark_report(df, want)
    assert list(report) == list(want_report)
    for subset in ("tnt/", "syn/", ""):
        for target in ("mos", "dmos"):
            for metric in ("plcc", "srcc", "ktcc"):
                assert f"{subset}{target}/{metric}" in report
        assert f"{subset}mos/l1" in report
    for k, v in want_report.items():
        assert abs(report[k] - v) <= 1e-6, k


def test_report_without_optional_columns_matches_jax(bench):
    # no DMOS and no DISTS column, a subset with one video left out
    root, path = bench
    rows = [{k: r[k] for k in ("reference_filename", "distorted_filename", "MOS")}
            for r in ttrain_cli.read_rows(path)][3:]
    scores = np.linspace(0.1, 0.9, len(rows))
    report = tbench.benchmark_report(rows, scores)
    want = jbench.benchmark_report(pd.DataFrame(rows).astype({"MOS": float}), scores)
    assert list(report) == list(want) and "tnt/mos/plcc" not in report
    assert report["syn/mos/plcc"] == pytest.approx(want["syn/mos/plcc"], abs=1e-6)
    assert report["mos/srcc"] == pytest.approx(1.0)


def test_train_nr_logs_the_benchmark_report(bench, tmp_path):
    # one epoch at 32² / 28² on the CPU, then the benchmark pass through
    # NRTrainer.score_video: every report key in the metrics log
    root, path = bench
    data = str(tmp_path / "nr")
    nr_csv = tsynth.make_nr_tree(data, scenes=("chair", "drums"), methods=("nerfacto",),
                                 frames=2, hw=(48, 48))
    out = str(tmp_path / "run")
    assert ttrain_cli.main([
        "--data-dir", data, "--scores-csv", nr_csv, "--output-dir", out, "--epochs", "1",
        "--vit-depth", "1", "--refine-up-depth", "1", "--transformer-decoder-depth", "0",
        "--render-size", "32", "--sem-size", "28", "--batch-size", "2",
        "--num-workers", "0", "--device", "cpu", "--test-every", "1",
        "--test-scores-csv", path, "--test-data-dir", root,
        "--test-max-frames", "2"]) == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    test = [r for r in logs if any(k.startswith("Test Metrics Dict/") for k in r)]
    assert len(test) == 1 and test[0]["step"] == 0
    keys = {k[len("Test Metrics Dict/"):] for k in test[0] if k != "step"}
    rows = ttrain_cli.read_rows(path)
    assert keys == set(tbench.benchmark_report(rows, np.linspace(0, 1, len(rows))))
    assert all(np.isfinite(v) for k, v in test[0].items() if k != "step")
    shutil.rmtree(out)  # a checkpoint with Adam's state is ~0.5 GB
