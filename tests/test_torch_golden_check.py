"""``tools/golden_check`` of the port against the JAX tool on the CPU: the
same two seeded PNGs (larger than 256, so both take PIL's bilinear resize)
scored with the same VGG weights (a ``.npz`` both read) and the bundled
α/β; the CLI's exit codes; and the golden 0.3347 check itself, which skips
without the torchvision VGG16 checkpoint and the reference's demo images,
as the JAX package's does.

Tolerance: the fp32 DISTS score at atol 1e-5 (measured gap below 1e-6 at
256²); ``prepare_image`` bit-equal."""
import os

import numpy as np
import pytest
from PIL import Image

from nerf_qa_torch.compat.pretrained import ENV_VGG
from nerf_qa_torch.tools import golden_check as tgold
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.tools import golden_check as jgold
from tests.torch_parity import jax_params, np_params, one_torch_thread  # noqa: F401

SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair(tmp_path_factory, np_params):  # noqa: F811
    root = tmp_path_factory.mktemp("golden")
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:300, 0:320].astype(np.float32)
    ref = np.stack([0.5 + 0.4 * np.sin(xx / 7.0) * np.cos(yy / 11.0),
                    (xx + yy) / 620.0, rng.random((300, 320))], -1)
    dist = np.clip(ref + rng.normal(0, 0.08, ref.shape), 0, 1)
    paths = []
    for name, img in (("r0.png", ref), ("r1.png", dist)):
        path = str(root / name)
        Image.fromarray((img * 255).round().astype(np.uint8)).save(path)
        paths.append(path)
    vgg = str(root / "vgg.npz")
    export_vgg16_to_npz(np_params, vgg)
    return paths[0], paths[1], vgg


def test_prepare_image_matches_jax(pair):
    ref, _, _ = pair
    got = tgold.prepare_image(ref)
    assert got.shape == (1, 256, 256, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jgold.prepare_image(ref))


def test_compute_pair_score_matches_jax(pair):
    ref, dist, vgg = pair
    got = tgold.compute_pair_score(ref, dist, vgg_ckpt=vgg, device="cpu")
    want = jgold.compute_pair_score(ref, dist, vgg_ckpt=vgg)
    assert 0.0 < got < 1.0
    assert got == pytest.approx(want, abs=SCORE_ATOL)
    assert tgold.GOLDEN == jgold.GOLDEN == 0.3347


def test_cli_exit_codes(pair, capsys):
    ref, dist, vgg = pair
    score = tgold.compute_pair_score(ref, dist, vgg_ckpt=vgg, device="cpu")
    common = ["--ref", ref, "--dist", dist, "--vgg-ckpt", vgg, "--device", "cpu"]
    assert tgold.main(common + ["--expect", str(score)]) == 0
    assert "-> OK" in capsys.readouterr().out
    assert tgold.main(common + ["--expect", str(score + 0.01)]) == 1
    assert "-> MISMATCH" in capsys.readouterr().out


def test_golden_0_3347():
    """DISTS(r1, r0) == 0.3347 (DISTS_pt.py:239) with real checkpoints."""
    ref = os.environ.get("NERF_QA_GOLDEN_REF", "")
    dist = os.environ.get("NERF_QA_GOLDEN_DIST", "")
    if not (os.environ.get(ENV_VGG) and os.path.exists(ref) and os.path.exists(dist)):
        pytest.skip("golden check needs $NERF_QA_VGG_CKPT (torchvision vgg16) and "
                    "$NERF_QA_GOLDEN_REF/$NERF_QA_GOLDEN_DIST (the reference's "
                    "images/r0.png, r1.png), which are not in the repository")
    score = tgold.compute_pair_score(ref, dist, device="cpu")
    assert abs(score - tgold.GOLDEN) < 1e-3, score
