"""The port's FR data feed, logging and fixture tree against the JAX
package's on the CPU: the four FR datasets (the same arrays for the same
seed, both mirrored JAX faults included), the factories' batch order, the
scene-grouped correlation report and sweep objective, the metric logger's
summary and per-video CSV, the figure JSON and ``make_fr_tree``; and that
no module of the port imports pandas, JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from nerf_qa_torch.data import datasets as tds
from nerf_qa_torch.data import factories as tfac
from nerf_qa_torch.data import native
from nerf_qa_torch.data import video as tvid
from nerf_qa_torch.eval import correlations as tcorr
from nerf_qa_torch.logging import figures as tfig
from nerf_qa_torch.logging import metrics as tmet
from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
from nerf_qa_torch.tools.run_fr import read_rows
from nerf_qa_tpu.data import datasets as jds
from nerf_qa_tpu.data import factories as jfac
from nerf_qa_tpu.data import video as jvid
from nerf_qa_tpu.eval import correlations as jcorr
from nerf_qa_tpu.logging import figures as jfig
from nerf_qa_tpu.logging import metrics as jmet
from nerf_qa_tpu.tools import make_synthetic_dataset as jsynth
from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fr_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fr"))
    csv = jsynth.make_fr_tree(root, scenes=("lego", "truck", "ship"),
                              methods_per_scene=2, frames=3, hw=(40, 48), seed=5)
    return root, csv


def _same_items(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        for g, w in zip(got_ds[i], want_ds[i], strict=True):
            if isinstance(w, dict):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_make_fr_tree_matches_jax(tmp_path):
    kw = dict(scenes=("lego", "room"), methods_per_scene=2, frames=2,
              hw=(24, 32), seed=3)
    for dists_col in (True, False):
        got = tsynth.make_fr_tree(str(tmp_path / f"port{dists_col}"),
                                  dists_col=dists_col, **kw)
        want = jsynth.make_fr_tree(str(tmp_path / f"jax{dists_col}"),
                                   dists_col=dists_col, **kw)
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read()
    for rel in ("Reference/lego_reference/000.png", "Renders/room_m1/001.png"):
        assert ((tmp_path / "portTrue" / rel).read_bytes()
                == (tmp_path / "jaxTrue" / rel).read_bytes()), rel


@pytest.mark.parametrize("in_memory", [False, True])
def test_test2_dataset_matches_jax_and_returns_mos_for_any_score_type(fr_tree, in_memory):
    root, csv = fr_tree
    got = tds.Test2Dataset(root, read_rows(csv), in_memory=in_memory)
    want = jds.Test2Dataset(root, pd.read_csv(csv), in_memory=in_memory)
    _same_items(got, want)
    assert got.get_scene_indices() == want.get_scene_indices()
    # the mirrored fault: the target is the MOS column even where a caller
    # fits to DMOS (JAX datasets.py:136)
    rows = read_rows(csv)
    assert got[0][2] == float(rows[0]["MOS"]) != float(rows[0]["DMOS"])
    if in_memory:  # uint8 cache, references deduplicated per (folder, frame)
        assert len(got._ref_cache) == len(want._ref_cache) == 3 * 3


def test_large_qa_dataset_matches_jax(fr_tree, tmp_path):
    root, csv = fr_tree
    rows = read_rows(csv)
    large = []
    for r in rows:
        for kind, src, name in (("references", "Reference", r["reference_folder"]),
                                ("nerf-renders", "Renders", r["distorted_folder"])):
            dst = tmp_path / kind / name
            if not dst.exists():
                shutil.copytree(os.path.join(root, src, name), dst)
        large.append({"distorted_filename": r["distorted_folder"],
                      "referenced_filename": r["reference_folder"],
                      "frame_count": r["frame_count"], "MOS": r["MOS"]})
    got = tds.LargeQADataset(str(tmp_path), large)
    want = jds.LargeQADataset(str(tmp_path), pd.DataFrame(large).astype(
        {"frame_count": int, "MOS": float}))
    _same_items(got, want)
    assert got.get_scene_indices() == want.get_scene_indices()


@pytest.fixture(scope="module")
def resized_tree(tmp_path_factory):
    """NeRF-QA layout at original size (264 x 280, so the paired random
    resize and the 256² crop both draw)."""
    root = tmp_path_factory.mktemp("nerfqa")
    rng = np.random.default_rng(9)
    rows = []
    for v in range(2):
        ref, dist = f"scene{v}_reference", f"scene{v}_m0"
        for base, name in (("Reference", ref), ("NeRF-QA_videos", dist)):
            for sub in ("original_size", "256x256"):
                (root / base / name / sub).mkdir(parents=True)
            for f in range(2):
                img = (rng.random((264, 280, 3)) * 255).astype(np.uint8)
                Image.fromarray(img).save(root / base / name / "original_size" / f"{f:03d}.png")
                Image.fromarray(img[:64, :64]).save(root / base / name / "256x256" / f"{f:03d}.png")
        rows.append({"distorted_filename": dist + ".mp4",
                     "reference_filename": ref + ".mp4", "MOS": str(3.0 + v)})
    return str(root), rows


def test_nerf_qa_resized_dataset_matches_jax(resized_tree):
    root, rows = resized_tree
    got = tds.NeRFQAResizedDataset(root, rows, rng=np.random.default_rng(4))
    want = jds.NeRFQAResizedDataset(root, pd.DataFrame(rows).astype({"MOS": float}),
                                    rng=np.random.default_rng(4))
    _same_items(got, want)
    assert got[0][0].shape == (256, 256, 3)


def test_test2_video_dataset_mirrors_the_swapped_folders(fr_tree, tmp_path):
    # JAX reads Reference/<distorted_folder> and Renders/<reference_folder>
    # (datasets.py:305-306); the port mirrors it
    root, csv = fr_tree
    row = read_rows(csv)[0]
    tree = tmp_path / "t2v"
    shutil.copytree(os.path.join(root, "Renders", row["distorted_folder"]),
                    tree / "Reference" / row["distorted_folder"])
    shutil.copytree(os.path.join(root, "Reference", row["reference_folder"]),
                    tree / "Renders" / row["reference_folder"])
    got = tds.Test2VideoDataset(row, str(tree))
    want = jds.Test2VideoDataset(pd.Series(row), str(tree))
    _same_items(got, want)
    assert got.files[0][0].startswith(str(tree / "Reference" / row["distorted_folder"]))
    assert got[0][0]["224x224"].shape == (224, 224, 3)


def _batches(loader):
    return [[np.asarray(x) for x in b] for b in loader]


@pytest.mark.parametrize("scene_balanced", [True, False])
def test_test2_loader_batch_order_matches_jax(fr_tree, scene_balanced):
    root, csv = fr_tree
    got = tfac.create_test2_dataloader(read_rows(csv), root, batch_size=4,
                                       scene_balanced=scene_balanced,
                                       num_workers=0, seed=2)
    want = jfac.create_test2_dataloader(pd.read_csv(csv), root, batch_size=4,
                                        scene_balanced=scene_balanced,
                                        num_workers=0, seed=2)
    assert len(got) == len(want)
    for epoch in (0, 1):
        for loader in (got, want):
            if loader.sampler is not None and hasattr(loader.sampler, "set_epoch"):
                loader.sampler.set_epoch(epoch)
        for g, w in zip(_batches(got), _batches(want), strict=True):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, b)


def test_resize_and_large_loaders_match_jax(resized_tree):
    root, rows = resized_tree
    got = tfac.create_nerf_qa_resize_dataloader(rows, root, batch_size=2,
                                                num_workers=0, seed=1)
    want = jfac.create_nerf_qa_resize_dataloader(
        pd.DataFrame(rows).astype({"MOS": float}), root, batch_size=2,
        num_workers=0, seed=1)
    for g, w in zip(_batches(got), _batches(want), strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)


def test_test_video_loader_reads_frame_dirs_and_refuses_mp4(tmp_path, fr_tree):
    root, csv = fr_tree
    row = read_rows(csv)[0]
    shutil.copytree(os.path.join(root, "Reference", row["reference_folder"]),
                    tmp_path / "Reference" / "ref")
    shutil.copytree(os.path.join(root, "Renders", row["distorted_folder"]),
                    tmp_path / "NeRF-QA_videos" / "dist")
    r = {"reference_filename": "ref", "distorted_filename": "dist"}
    got = tfac.create_test_video_dataloader(r, str(tmp_path))
    want = jfac.create_test_video_dataloader(r, str(tmp_path))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    # mp4s are no longer refused: each frame tree as a Motion-JPEG mp4
    # (written by the port) reads as the JAX package reads the same JPEGs
    # from frame directories
    if not native.available():
        pytest.skip(f"native decoder: {native.unavailable_reason()}")
    for (name, sub), frames in zip((("ref.mp4", "Reference"),
                                    ("dist.mp4", "NeRF-QA_videos")), want[::-1]):
        u8 = (frames * 255 + 0.5).astype(np.uint8)
        tvid.write_mjpeg_mp4(str(tmp_path / sub / name), u8)
        jpg_dir = tmp_path / "jpg" / name
        jpg_dir.mkdir(parents=True)
        for i, f in enumerate(u8):
            Image.fromarray(f).save(jpg_dir / f"{i:03d}.jpg", quality=90)
    got = tfac.create_test_video_dataloader({"reference_filename": "ref.mp4",
                                             "distorted_filename": "dist.mp4"},
                                            str(tmp_path))
    for g, name in zip(got, ("dist.mp4", "ref.mp4"), strict=True):
        np.testing.assert_array_equal(
            g, jvid.load_video_frames(str(tmp_path / "jpg" / name)))


def _video_report():
    rng = np.random.default_rng(4)
    pred, target, scene = {}, {}, {}
    vid = 0
    for s in ("train", "m60", "lego", "ship", "other"):
        for _ in range(4):
            t = rng.uniform(1, 5)
            pred[vid] = -t + rng.normal(0, 0.3)
            target[vid] = t
            scene[vid] = s
            vid += 1
    return pred, target, scene


def test_scene_grouped_correlations_and_combined_score_match_jax():
    pred, target, scene = _video_report()
    got = tcorr.scene_grouped_correlations(pred, target, scene)
    want = jcorr.scene_grouped_correlations(pred, target, scene)
    assert got == want  # the same scipy calls on the same float64 inputs
    assert tcorr.combined_score(got) == jcorr.combined_score(want)
    assert tcorr.REAL_SCENE_IDS == jcorr.REAL_SCENE_IDS
    assert tcorr.SYNTH_SCENE_IDS == jcorr.SYNTH_SCENE_IDS


def _fill(logger):
    rng = np.random.default_rng(6)
    for vid in range(8):
        n = 1 + vid % 3
        t = float(rng.uniform(1, 5))
        logger.add_entries(
            {"loss": rng.random(n), "mse": rng.random(n),
             "pred_score": t + rng.normal(0, 0.2, n), "mos": np.full(n, t)},
            video_ids=np.full(n, vid),
            scene_ids=np.full(n, ("lego", "truck", "train")[vid % 3]))


def test_metric_logger_summary_csv_and_figure_match_jax(tmp_path):
    got_logs, want_logs = {}, {}
    got = tmet.MetricCollectionLogger("Test Metrics Dict",
                                      log_fn=lambda logs, step: got_logs.update(logs))
    want = jmet.MetricCollectionLogger("Test Metrics Dict",
                                       log_fn=lambda logs, step: want_logs.update(logs))
    for logger in (got, want):
        _fill(logger)
    assert got.per_scene_figure() == want.per_scene_figure()
    got.write_video_metrics_csv(str(tmp_path / "port.csv"))
    want.video_metrics_df().to_csv(str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    got.log_summary(3)
    want.log_summary(3)
    assert got_logs.keys() == want_logs.keys()
    assert "Test Metrics Dict/combined_score" in got_logs
    for k, v in want_logs.items():
        assert got_logs[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert got.last_correlations == pytest.approx(want.last_correlations)


def test_figure_json_matches_jax(tmp_path):
    x = {0: 0.1, 1: 0.2, 2: 0.3, 3: 0.5, 4: 0.6}
    y = {0: 4.8, 1: 4.1, 2: 3.3, 3: 2.0, 4: 1.4}
    scenes = {0: "lego", 1: "lego", 2: "lego", 3: "truck", 4: "truck"}
    got = tfig.per_scene_regression_figure(x, y, scenes)
    assert got == jfig.per_scene_regression_figure(x, y, scenes)
    path = tfig.write_figure_json(got, str(tmp_path / "f.plotly.json"))
    with open(path) as f:
        assert json.load(f) == got
    assert tfig.to_wandb(got) is None  # no wandb / plotly here


@pytest.mark.parametrize("policy", ["aspect", "square", "full_size", "pixel_count"])
@pytest.mark.parametrize("hw", [(300, 420), (120, 96)])
def test_prep_policies_match_jax(policy, hw):
    from nerf_qa_torch.tools.prep_fr import apply_policy as tpolicy
    from nerf_qa_tpu.tools.prep_fr import apply_policy as jpolicy

    img = np.random.default_rng(hw[0]).random((*hw, 3), dtype=np.float32)
    np.testing.assert_array_equal(tpolicy(img, policy), jpolicy(img, policy))


def test_no_port_module_imports_pandas_or_jax():
    # every module of the port, and chip_smoke.py, imported in a process
    # where pandas, jax, the JAX package, matplotlib, yaml and wandb cannot
    # be imported (the card's machine has none of them)
    code = """
import importlib, pkgutil, sys
for name in ("pandas", "jax", "nerf_qa_tpu", "matplotlib", "yaml", "wandb"):
    sys.modules[name] = None
import nerf_qa_torch
names = [m.name for m in pkgutil.walk_packages(nerf_qa_torch.__path__, "nerf_qa_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(len(names))
print(" ".join(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    count, names = out.stdout.strip().splitlines()
    assert int(count) >= 60
    # the data feed and the service (the decoder's bindings, mp4, serve and
    # the feed benchmarks) among them
    assert {"nerf_qa_torch.data.native", "nerf_qa_torch.data.video",
            "nerf_qa_torch.tools.serve", "nerf_qa_torch.tools.convert_video",
            "nerf_qa_torch.tools.bench_feed",
            "nerf_qa_torch.tools.bench_host_decode"} <= set(names.split())
    # the comparison and readiness tools
    assert {"nerf_qa_torch.eval.iqa", "nerf_qa_torch.eval.retrieval",
            "nerf_qa_torch.tools.golden_check", "nerf_qa_torch.tools.verify_assets",
            "nerf_qa_torch.tools.plot_results", "nerf_qa_torch.tools.sweep",
            "nerf_qa_torch.tools.init_sweep"} <= set(names.split())
    # many devices and the last utilities
    assert {"nerf_qa_torch.parallel.mesh", "nerf_qa_torch.parallel.distributed",
            "nerf_qa_torch.parallel.spatial", "nerf_qa_torch.utils.benchtime",
            "nerf_qa_torch.utils.profiling"} <= set(names.split())
