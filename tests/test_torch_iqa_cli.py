"""``prep_fr --iqa`` of the port against the JAX tool on the CPU: one
synthetic Test2 tree through both packages' ``prep_fr`` with all eleven
comparison-metric columns (the same VGG ``.npz`` and the same seeded LPIPS /
ST-LPIPS ``lin`` checkpoints), the argument order of each metric (VIF and
MAD take the reference first, NLPD's depth is clamped to the frame), and
the error an unknown metric name gives.

Tolerance: per-video means, stds, extrema and per-frame lists at rel 1e-4,
atol 2e-6 (the ``_frames`` lists are rounded to 6 decimals); MAD at rel
1e-3, the bar ``tests/test_torch_iqa.py`` states and measures."""
import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.eval import iqa as tiqa
from nerf_qa_torch.tools import prep_fr as tprep
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.eval import iqa as jiqa
from nerf_qa_tpu.tools import prep_fr as jprep
from nerf_qa_tpu.tools.make_synthetic_dataset import make_fr_tree
from tests.torch_parity import jax_params, np_params, one_torch_thread  # noqa: F401

RTOL = 1e-4
ATOL = 2e-6
MAD_RTOL = 1e-3
METRICS = "psnr,ssim,ms-ssim,lpips,st-lpips,gmsd,vif,fsim,fsimc,nlpd,mad"
COLUMNS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS", "ST-LPIPS", "GMSD", "VIF", "FSIM",
           "FSIMc", "NLPD", "MAD")


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _lin_checkpoint(path, seed):
    rng = np.random.default_rng(seed)
    torch.save({f"lin{k}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1), dtype=np.float32))
        for k, c in enumerate(tiqa.LPIPS_STAGE_CHANNELS)}, path)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory, np_params):  # noqa: F811
    root = tmp_path_factory.mktemp("iqa_cli")
    data = str(root / "data")
    # 176² frames: MS-SSIM's five scales need a min side of 176
    scores = make_fr_tree(data, scenes=("lego", "truck"), methods_per_scene=1,
                          frames=2, hw=(176, 176), seed=2, dists_col=False)
    vgg = str(root / "vgg.npz")
    export_vgg16_to_npz(np_params, vgg)
    return (root, data, scores, vgg, _lin_checkpoint(str(root / "lpips.pth"), 0),
            _lin_checkpoint(str(root / "stlpips.pth"), 1))


def test_prep_fr_iqa_columns_match_jax(tree):
    root, data, scores, vgg, lp, stlp = tree
    out = {}
    for pkg, main, more in (("jax", jprep.main, []),
                            ("port", tprep.main, ["--device", "cpu"])):
        out[pkg] = str(root / f"iqa_{pkg}.csv")
        main(["--data-dir", data, "--scores-csv", scores, "--policy", "full_size",
              "--compute-dtype", "float32", "--batch-size", "2", "--no-adists",
              "--vgg-ckpt", vgg, "--iqa", METRICS, "--lpips-ckpt", lp,
              "--stlpips-ckpt", stlp, "--output-csv", out[pkg]] + more)
    got, want = _read(out["port"]), _read(out["jax"])
    assert list(got[0]) == list(want[0])
    assert len(got) == len(want) == 2
    for m in ("DISTS", *COLUMNS):
        rtol = MAD_RTOL if m == "MAD" else RTOL
        for key in (m, f"{m}_std", f"{m}_min", f"{m}_max"):
            g = np.array([float(r[key]) for r in got])
            w = np.array([float(r[key]) for r in want])
            assert np.isfinite(g).all(), key
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-4 if m == "DISTS" else ATOL,
                                       err_msg=key)
        for g, w in zip(got, want):
            assert g["distorted_folder"] == w["distorted_folder"]
            np.testing.assert_allclose(json.loads(g[f"{m}_frames"]),
                                       json.loads(w[f"{m}_frames"]), rtol=rtol,
                                       atol=1e-4 if m == "DISTS" else ATOL, err_msg=m)


def test_prep_fr_iqa_wiring_argument_order():
    """The PairScorer calls every metric as fn(render, ref); VIF's
    information model and MAD's contrast masking read the reference first,
    so they are wired swapped. An asymmetric (blurred) pair shows a wrong
    order; NLPD's depth is clamped to the 48 px side."""
    from scipy.ndimage import convolve

    rng = np.random.default_rng(0)
    ref = rng.random((1, 48, 64, 3), dtype=np.float32)
    render = np.clip(convolve(ref[0], np.ones((5, 5, 1)) / 25.0, mode="nearest"),
                     0, 1)[None].astype(np.float32)
    names = ("mad", "vif", "nlpd")
    out = tprep.PairScorer(compute_dtype="float32", with_adists=False,
                           iqa_metrics=names, device="cpu").score_pairs(ref, render)
    want = jprep.PairScorer(compute_dtype="float32", with_adists=False,
                            iqa_metrics=names).score_pairs(ref, render)
    r, d = torch.from_numpy(ref), torch.from_numpy(render)

    mad_correct = float(tiqa.mad(r, d)[0])
    mad_swapped = float(tiqa.mad(d, r)[0])
    assert abs(mad_correct - mad_swapped) > 1e-3, (
        "fixture not asymmetric enough to detect a swap")
    assert out["MAD"][0] == pytest.approx(mad_correct, rel=1e-6)
    assert out["MAD"][0] == pytest.approx(
        float(jiqa.mad(jnp.asarray(ref), jnp.asarray(render))[0]), rel=MAD_RTOL)
    assert out["VIF"][0] == pytest.approx(float(tiqa.vif(r, d)[0]), rel=1e-6)
    levels = tiqa.nlpd_max_levels(48, 64)
    assert levels == 5  # 3 * 2^(5-1) = 48 == min side, 6 would pad-fail
    assert out["NLPD"][0] == pytest.approx(float(tiqa.nlpd(d, r, levels=levels)[0]),
                                           rel=1e-6)
    for key in ("VIF", "NLPD"):
        assert out[key][0] == pytest.approx(float(want[key][0]), rel=RTOL), key


def test_prep_fr_unknown_iqa_metric_exits(tree, tmp_path):
    _, data, scores, vgg, _, _ = tree
    with pytest.raises(SystemExit, match="unknown --iqa metric 'sharpness'"):
        tprep.main(["--data-dir", data, "--scores-csv", scores, "--iqa", "psnr,sharpness",
                    "--vgg-ckpt", vgg, "--device", "cpu",
                    "--output-csv", str(tmp_path / "x.csv")])
