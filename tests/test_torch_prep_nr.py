"""The port's NR prep (tools/prep_nr.py) against the JAX package's, on the
CPU, on one synthetic NR tree with one VGG (``init_vgg16_params(seed=0)``
as a ``.npz`` that both read), fp32.

* The CSV writer is byte-identical to the JAX tool's (pandas) for the same
  scores and log ranges.
* On the real run the columns agree: text columns exactly, per-frame DISTS
  and the per-scene DISTS_std / DISTS_mean to one unit of their 6th
  decimal (scores ~1e-7 apart can round either way).
* The float ADISTS maps agree to 1e-6 (absolute: the map is 1 − a sum of
  fp32 terms; measured ≤ 5.4e-7), so each frame's -log10 range agrees to
  1e-6 / (ln 10 · the map's least value), the bound that 1e-6 implies
  where the map is smallest (measured gaps up to 2.4e-5 at a map value
  of 0.0033, and 1.4e-6 at the range's other end).
* The score-map PNGs agree to one 8-bit level (a pixel at a level's edge
  can fall either way).
* The dataset's score-map items read back the same maps as the JAX
  dataset's."""
import filecmp
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from nerf_qa_torch.compat.pretrained import resolve_vgg_params
from nerf_qa_torch.config import ADISTSConfig as TAConfig
from nerf_qa_torch.data import datasets as tdatasets
from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
from nerf_qa_torch.tools import prep_nr as tprep
from nerf_qa_torch.tools.train_nr import read_rows
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.config import ADISTSConfig as JAConfig
from nerf_qa_tpu.core import adists as jadists
from nerf_qa_tpu.data import datasets as jdatasets
from nerf_qa_tpu.tools import prep_nr as jprep
from tests.torch_parity import jax_params, np_params, one_torch_thread  # noqa: F401

FRAMES = ["000.png", "001.png"]


@pytest.fixture(scope="module")
def prepped(tmp_path_factory, np_params):
    """The tree prepped by each tool in its own copy: (port root, JAX
    root, VGG npz)."""
    base = tmp_path_factory.mktemp("prep_nr")
    vgg = str(base / "vgg.npz")
    export_vgg16_to_npz(np_params, vgg)
    tsynth.make_nr_tree(str(base / "port"), scenes=("chair", "drums"),
                        methods=("nerfacto", "instant-ngp"), frames=2, hw=(48, 64))
    shutil.copytree(base / "port", base / "jax")
    args = ["--score-maps", "--compute-dtype", "float32", "--batch-size", "2",
            "--vgg-ckpt", vgg]
    assert tprep.main(["--data-dir", str(base / "port"), "--device", "cpu", *args]) == 0
    jprep.main(["--data-dir", str(base / "jax"), *args])
    return base / "port", base / "jax", vgg


COLUMNS = ["scene", "method", "frame_count", "basenames", "DISTS_frames", "render_dir",
           "gt_dir", "score_map_log_min", "score_map_log_max", "DISTS_std", "DISTS_mean"]


def _lists(rows, key):
    return np.asarray([tdatasets.parse_list_column(r[key]) for r in rows], np.float64)


def test_csv_columns_match_jax(prepped):
    port, jax_root, _ = prepped
    got, want = read_rows(str(port / "output.csv")), read_rows(str(jax_root / "output.csv"))
    assert list(got[0]) == list(want[0]) == COLUMNS and len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("scene", "method", "frame_count", "basenames", "render_dir", "gt_dir"):
            assert g[k] == w[k], k
    for k in ("DISTS_frames", "DISTS_std", "DISTS_mean"):
        assert np.abs(_lists(got, k) - _lists(want, k)).max() <= 1e-6 + 1e-12, k


def test_csv_writer_is_byte_identical(prepped, monkeypatch, tmp_path):
    # both tools with the same stand-in scores and log ranges: the CSVs are
    # byte for byte the same (pandas' to_csv against the port's csv module)
    port, _, vgg = prepped

    def scores(scorer, color_dir, gt_dir, batch_size=8):
        names = sorted(os.listdir(color_dir))
        seed = sum(map(ord, color_dir[-24:]))
        return names, np.random.default_rng(seed).random(len(names)) / 7

    def maps(vgg_params, color_dir, gt_dir, out_dir, *a, **k):
        rng = np.random.default_rng(len(color_dir))
        n = len(os.listdir(color_dir))
        return ([round(float(v), 6) for v in rng.random(n) + 1],
                [round(float(v), 6) for v in rng.random(n) + 2])

    class NoScorer:
        def __init__(self, *a, **k):
            self.vgg = self.vgg_params = self.device = None

    for mod in (tprep, jprep):
        monkeypatch.setattr(mod, "compute_frame_scores", scores)
        monkeypatch.setattr(mod, "write_score_maps", maps)
        monkeypatch.setattr(mod, "PairScorer", NoScorer)
    for flags in ([], ["--score-maps"]):
        out = [str(tmp_path / f"{name}{len(flags)}.csv") for name in ("port", "jax")]
        assert tprep.main(["--data-dir", str(port), "--output-csv", out[0],
                           "--device", "cpu", *flags]) == 0
        jprep.main(["--data-dir", str(port), "--output-csv", out[1], *flags])
        assert filecmp.cmp(*out, shallow=False), [open(f).read() for f in out]


def test_scene_stats_match_jax(prepped):
    port, _, _ = prepped
    rows = read_rows(str(port / "output.csv"))
    bare = [{k: v for k, v in r.items() if k not in ("DISTS_std", "DISTS_mean")}
            for r in rows]
    got = tprep.add_scene_stats(bare)
    want = jprep.add_scene_stats(pd.DataFrame(bare))
    assert [r["DISTS_std"] for r in got] == list(want["DISTS_std"])
    assert [r["DISTS_mean"] for r in got] == list(want["DISTS_mean"])


def test_score_maps_within_one_level(prepped):
    port, jax_root, _ = prepped
    diffs = []
    for scene in ("chair", "drums"):
        for method in ("nerfacto", "instant-ngp"):
            for name in FRAMES:
                rel = f"{scene}/{method}/score-map/{name}"
                a = np.asarray(Image.open(port / rel), np.int32)
                b = np.asarray(Image.open(jax_root / rel), np.int32)
                assert a.shape == b.shape == (256, 256)
                assert a.min() == 0 and a.max() == 255
                diffs.append(int(np.abs(a - b).max()))
    assert max(diffs) <= 1, diffs


def test_float_maps_and_log_ranges_match_jax(prepped):
    # the ADISTS maps of the port and of JAX frame by frame (1e-6), and the
    # -log10 range the CSV records, within the bound the map's bar implies
    # (module docstring); the port's recorded range is its own map's
    port, _, vgg = prepped
    import jax

    from nerf_qa_torch.data.imaging import load_image_rgb, resize_image
    from nerf_qa_tpu.compat.pretrained import resolve_vgg_params as jresolve

    tvgg = resolve_vgg_params(vgg)
    jvgg = jresolve(vgg)
    amap = jax.jit(lambda x, y: jadists.forward(jvgg, x, y, JAConfig(), as_map=True))
    rows = {(r["scene"], r["method"]): r for r in read_rows(str(port / "output.csv"))}
    for scene, method in (("chair", "nerfacto"), ("drums", "instant-ngp")):
        row = rows[(scene, method)]
        for f, name in enumerate(FRAMES):
            render = resize_image(load_image_rgb(str(port / scene / method / "color" / name)),
                                  256, 256)
            gt = resize_image(load_image_rgb(str(port / scene / "gt" / name)), 256, 256)
            with torch.no_grad():
                got = tprep.adists.forward(tvgg, torch.from_numpy(gt[None]),
                                           torch.from_numpy(render[None]), TAConfig(),
                                           as_map=True)[0].numpy()
            want = np.asarray(amap(gt[None], render[None]))[0]
            assert np.abs(got - want).max() <= 1e-6
            logm = tprep.log_score_map(tvgg, torch.from_numpy(gt[None]),
                                       torch.from_numpy(render[None]), TAConfig())[0]
            np.testing.assert_array_equal(logm, -np.log10(np.clip(got, 1e-6, None)))
            _, lo, hi = tprep.encode_log_map(logm)
            assert round(lo, 6) == tdatasets.parse_list_column(row["score_map_log_min"])[f]
            assert round(hi, 6) == tdatasets.parse_list_column(row["score_map_log_max"])[f]
            jlog = -np.log10(np.clip(want, 1e-6, None))
            bar = 1e-6 / (np.log(10) * float(min(got.min(), want.min())))
            assert abs(lo - float(jlog.min())) <= bar
            assert abs(hi - float(jlog.max())) <= bar


def test_score_map_dataset_items_match_jax(prepped):
    # the dataset's score-map mode on the port's prepped tree: the same
    # arrays as the JAX dataset from the same seed (rotation and crops
    # on), the maps decoded with the frame's log range
    port, _, _ = prepped
    kw = dict(mode="score-map", is_train=True, render_size=64, sem_size=56)
    t = tdatasets.NerfNRQADataset(read_rows(str(port / "output.csv")), str(port),
                                  rng=np.random.default_rng(4), **kw)
    j = jdatasets.NerfNRQADataset(pd.read_csv(port / "output.csv"), str(port),
                                  rng=np.random.default_rng(4), **kw)
    for idx in (0, 5, 2, 7):
        got, want = t[idx], j[idx]
        assert len(got) == len(want) == 5
        np.testing.assert_array_equal(got[0], want[0])
        for k in ("256x256", "224x224"):
            np.testing.assert_array_equal(got[1][k], want[1][k])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3:] == want[3:]
        row = t.rows[got[3]]
        lo = tdatasets.parse_list_column(row["score_map_log_min"])[got[4]]
        hi = tdatasets.parse_list_column(row["score_map_log_max"])[got[4]]
        assert got[2].shape == (256, 256, 3)
        assert lo - 1e-6 <= got[2][..., 1].min() and got[2][..., 1].max() <= hi + 1e-6


def test_prep_needs_a_gpu_unless_asked(prepped, monkeypatch):
    port, _, _ = prepped
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.main(["--data-dir", str(port), "--output-csv", str(port / "x.csv")])
