"""The port's score CLI with ``--metric adists|both`` against the JAX CLI
on the CPU: the same PNG frame directories and the same VGG ``.npz``."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_qa_torch.config import ADISTSConfig as TConfig
from nerf_qa_torch.core import adists as ta
from nerf_qa_torch.data.video import load_video_frames
from nerf_qa_torch.tools.score import adists_batch
from nerf_qa_torch.tools.score import main as tscore_main
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.tools.score import main as jscore_main
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory, jax_params):
    """Three 64x64 frame pairs (textured, so ADISTS is well away from 0)
    and the JAX VGG params as the CLIs' --vgg-ckpt."""
    root = tmp_path_factory.mktemp("tscore_adists")
    ref_dir, dist_dir = root / "ref", root / "dist"
    ref_dir.mkdir()
    dist_dir.mkdir()
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    for i in range(3):
        ref = np.stack([yy, xx, np.sin(6 * (xx + yy + 0.1 * i)) * 0.5 + 0.5], -1)
        ref = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1)
        dist = np.clip(ref + rng.normal(0, 0.08, ref.shape), 0, 1)
        Image.fromarray((ref * 255).astype(np.uint8)).save(ref_dir / f"{i:03d}.png")
        Image.fromarray((dist * 255).astype(np.uint8)).save(dist_dir / f"{i:03d}.png")
    vgg_npz = str(root / "vgg.npz")
    export_vgg16_to_npz(jax_params, vgg_npz)
    return str(ref_dir), str(dist_dir), vgg_npz


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("metric", ["adists", "both"])
def test_cli_matches_jax_cli(pair_dirs, capsys, metric):
    # --fp32 on both sides, batch 2 (a padded tail): atol 1e-4 per metric
    ref_dir, dist_dir, vgg = pair_dirs
    common = ["--ref", ref_dir, "--dist", dist_dir, "--fp32", "--json",
              "--vgg-ckpt", vgg, "--batch-size", "2", "--metric", metric]
    want = _run(jscore_main, common, capsys)
    got = _run(tscore_main, common + ["--device", "cpu"], capsys)
    keys = {"adists"} if metric == "adists" else {"dists", "adists"}
    assert got.keys() == want.keys() == keys
    for m in keys:
        assert got[m]["frames"] == want[m]["frames"] == 3
        gap = abs(got[m]["video_score"] - want[m]["video_score"])
        print(f"{m} CLI gap port vs JAX: {gap:.3e}")
        assert gap <= 1e-4
    assert got["adists"]["video_score"] > 1e-3


def test_cli_both_csv_columns(pair_dirs, tmp_path, capsys):
    ref_dir, dist_dir, vgg = pair_dirs
    csv = str(tmp_path / "s.csv")
    _run(tscore_main, ["--ref", ref_dir, "--dist", dist_dir, "--metric", "both",
                       "--vgg-ckpt", vgg, "--json", "--device", "cpu",
                       "--out-csv", csv], capsys)
    lines = open(csv).read().strip().splitlines()
    assert lines[0] == "frame,dists,adists" and len(lines) == 4
    assert all(len(row.split(",")) == 3 for row in lines[1:])


def test_cli_text_output(pair_dirs, capsys):
    ref_dir, dist_dir, vgg = pair_dirs
    assert tscore_main(["--ref", ref_dir, "--dist", dist_dir, "--metric", "adists",
                        "--vgg-ckpt", vgg, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("adists: ") and "mean of 3 frame scores" in out


def test_cli_passes_dist_as_x(pair_dirs, torch_model):
    # the JAX CLI's order: adists.forward(vgg, x=dist, y=ref); the other
    # order gives another score (ADISTS is asymmetric)
    ref_dir, dist_dir, _ = pair_dirs
    ref = load_video_frames(ref_dir)
    dist = load_video_frames(dist_dir)
    cfg = TConfig()
    got = adists_batch(torch_model, dist, ref, cfg)
    x, y = torch.from_numpy(dist), torch.from_numpy(ref)
    torch.testing.assert_close(got, ta.forward(torch_model, x, y, cfg, as_loss=False),
                               rtol=0, atol=0)
    swapped = ta.forward(torch_model, y, x, cfg, as_loss=False)
    assert float((got - swapped).abs().max()) > 1e-5
