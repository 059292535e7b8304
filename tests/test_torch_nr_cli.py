"""The NR mode of the port's score CLI: a reference-layout .pth from a seeded
port decoder scores a frame directory on the CPU as the model called
directly does, and an orbax directory is refused."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_qa_torch.compat import pretrained as tpre
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.core.dists import weights_from_arrays
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.tools import score as tscore
from tests.torch_parity import NR_RENDER, NR_SEM, nr_config, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def nr_pth(tmp_path_factory):
    """A reference-layout NR .pth from a seeded port decoder, with α/β."""
    cfg = nr_config(TConfig)
    decoder = init_lecun_normal_(NRDecoder(cfg), torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    alpha = rng.uniform(0.05, 0.15, 1475).astype(np.float32)
    beta = rng.uniform(0.05, 0.15, 1475).astype(np.float32)
    sd = dict(decoder.state_dict())
    sd["encoder.dists.alpha"] = torch.from_numpy(alpha).view(1, -1, 1, 1)
    sd["encoder.dists.beta"] = torch.from_numpy(beta).view(1, -1, 1, 1)
    path = tmp_path_factory.mktemp("nr") / "model.pth"
    torch.save(sd, path)
    return str(path), decoder, alpha, beta


def test_nr_cli_matches_model(nr_pth, tmp_path, monkeypatch, capsys):
    # the CLI (host resize, batches of 2 with a padded tail, bf16 serving
    # config) against the same model called directly: atol 1e-5 (the CSV
    # holds 6 decimals)
    path, decoder, alpha, beta = nr_pth
    monkeypatch.setattr(tscore, "NR_SIZES", (NR_RENDER, NR_SEM))
    for env in (tpre.ENV_VGG, tpre.ENV_VIT, tpre.ENV_JBU, tpre.ENV_DISTS):
        monkeypatch.delenv(env, raising=False)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (3, 80, 90, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(frames_dir / f"{i:03d}.png")
    csv = tmp_path / "nr.csv"
    rc = tscore.main(["--nr", "--nr-ckpt", path, "--dist", str(frames_dir),
                      "--vit-depth", "2", "--transformer-decoder-depth", "1",
                      "--batch-size", "2", "--device", "cpu", "--json",
                      "--out-csv", str(csv)])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = np.loadtxt(csv, delimiter=",", skiprows=1)[:, 1]
    assert summary["nr"]["frames"] == 3

    cfg = nr_config(TConfig, TDConfig(compute_dtype="bfloat16", stats_impl="kernel"))
    model = NRModel(tpre.resolve_vgg_params(), weights_from_arrays(alpha, beta, cfg.dists),
                    cfg, vit=tpre.resolve_vit_params(depth=2, grid_size=NR_SEM // 14),
                    jbu=tpre.resolve_jbu_params(), decoder=decoder,
                    render_size=NR_RENDER, sem_size=NR_SEM)
    scorer = tscore.NRScorer(model, batch_size=3, device="cpu")
    r256, r224 = scorer.prep_frames(frames.astype(np.float32) / 255.0)
    with torch.no_grad():
        want = model(torch.from_numpy(r256), torch.from_numpy(r224)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(summary["nr"]["video_score"] - float(want.mean())) < 1e-5


def test_nr_cli_rejects_orbax_dir_and_missing_ckpt(tmp_path):
    frame = tmp_path / "f.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(frame)
    with pytest.raises(SystemExit, match="orbax"):
        tscore.main(["--nr", "--nr-ckpt", str(tmp_path), "--dist", str(frame),
                     "--device", "cpu"])
    with pytest.raises(SystemExit, match="--nr-ckpt"):
        tscore.main(["--nr", "--dist", str(frame), "--device", "cpu"])
