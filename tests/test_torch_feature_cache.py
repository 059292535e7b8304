"""The port's ViT-token cache (data/feature_cache.py,
tools/cache_nr_features.py) against the JAX package's, on the CPU: a cache
written by either package reads in the other's TokenCacheReader (one
packed fp16 .npy per video and its JSON sidecar); gather and coverage; the
cached forward and training step against the direct ones (atol 2e-3, the
JAX package's bar, tests/test_feature_cache.py:79: the tokens are stored
in fp16); and the two cache-builder CLIs on one synthetic tree with one
DINOv2-layout ViT checkpoint."""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from nerf_qa_torch.compat.pretrained import resolve_vgg_params
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.config import TrainConfig as TTrainConfig
from nerf_qa_torch.data import feature_cache as tcache
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_
from nerf_qa_torch.tools import cache_nr_features as tcli
from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
from nerf_qa_torch.tools.train_nr import read_rows
from nerf_qa_torch.train.nr_train import NRTrainer
from nerf_qa_tpu.data import feature_cache as jcache
from nerf_qa_tpu.tools import cache_nr_features as jcli
from tests.torch_parity import one_torch_thread  # noqa: F401

R256, R224 = 64, 56
ATOL = 2e-3
DIRS = ["chair/nerfacto/color", "drums/ngp/color"]


def _tokens():
    t0 = np.random.default_rng(0).random((4, 4, 4, 8), np.float32)
    t1 = np.random.default_rng(1).random((3, 4, 4, 8), np.float32)
    return t0, t1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_reads_in_both_packages(tmp_path, writer):
    # the same files from either writer; both readers give the fp16 values
    t0, t1 = _tokens()
    write = tcache.write_token_cache if writer == "port" else jcache.write_token_cache
    for rd, t in zip(DIRS, (t0, t1)):
        assert (tcache.token_cache_path(str(tmp_path), rd)
                == jcache.token_cache_path(str(tmp_path), rd))
        write(tcache.token_cache_path(str(tmp_path), rd), t,
              [f"{i:03d}.png" for i in range(len(t))])
    f = tcache.token_cache_path(str(tmp_path), DIRS[1])
    with open(f + tcache.META_SUFFIX) as fh:
        assert json.load(fh) == {"shape": [3, 4, 4, 8], "dtype": "float16",
                                 "basenames": ["000.png", "001.png", "002.png"]}
    assert np.load(f).dtype == np.float16
    port = tcache.TokenCacheReader(str(tmp_path), [{"render_dir": d} for d in DIRS])
    jax_reader = jcache.TokenCacheReader(str(tmp_path), pd.DataFrame({"render_dir": DIRS}))
    vid, frame = np.array([1, 0, 0]), np.array([2, 0, 3])
    got, want = port.gather(vid, frame), jax_reader.gather(vid, frame)
    assert got.dtype == np.float32 and got.shape == (3, 4, 4, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], t1[2].astype(np.float16))
    np.testing.assert_array_equal(got[2], t0[3].astype(np.float16))


def test_coverage_counts_cached_videos(tmp_path):
    t0, t1 = _tokens()
    rows = [{"render_dir": d} for d in DIRS]
    reader = tcache.TokenCacheReader(str(tmp_path), rows)
    assert reader.coverage() == (0, 2)
    tcache.write_token_cache(tcache.token_cache_path(str(tmp_path), DIRS[0]), t0, ["a"] * 4)
    assert reader.coverage() == (1, 2)
    tcache.write_token_cache(tcache.token_cache_path(str(tmp_path), DIRS[1]), t1, ["b"] * 3)
    assert reader.coverage() == (2, 2)
    assert reader.coverage() == jcache.TokenCacheReader(
        str(tmp_path), pd.DataFrame({"render_dir": DIRS})).coverage()


@pytest.fixture(scope="module")
def tiny_model():
    cfg = TConfig(transformer_decoder_depth=0, refine_up_depth=1, dropout_rate=0.0)
    vit = init_vit_(ViTS14(depth=1, grid_size=R224 // 14), torch.Generator().manual_seed(0))
    return NRModel(resolve_vgg_params(seed=0), cfg=cfg, vit=vit,
                   render_size=R256, sem_size=R224)


def _fp16_tokens(model, r224):
    with torch.no_grad():
        out = model.vit(torch.from_numpy(r224))
    gh, gw = out["grid"]
    return out["x_norm_patchtokens"].reshape(r224.shape[0], gh, gw, -1).half().float()


def test_cached_forward_matches_direct(tiny_model):
    rng = np.random.default_rng(0)
    r256 = rng.random((2, R256, R256, 3), np.float32)
    r224 = rng.random((2, R224, R224, 3), np.float32)
    with torch.no_grad():
        direct = tiny_model(torch.from_numpy(r256), torch.from_numpy(r224))
        cached = tiny_model(torch.from_numpy(r256), torch.from_numpy(r224),
                            _fp16_tokens(tiny_model, r224))
    assert not torch.equal(cached, direct)  # the cache's fp16 rounding shows
    torch.testing.assert_close(cached, direct, rtol=0, atol=ATOL)


def test_cached_train_step_matches_direct(tiny_model):
    # one Adam step from the same decoder, cached and direct: losses and
    # the scores after it within ATOL
    import copy

    rng = np.random.default_rng(1)
    gt = rng.random((2, R256, R256, 3), np.float32)
    r256 = np.clip(gt + rng.normal(0, 0.05, gt.shape).astype(np.float32), 0, 1)
    r224 = rng.random((2, R224, R224, 3), np.float32)
    toks = _fp16_tokens(tiny_model, r224).numpy()
    out = {}
    for name, kw in (("direct", {}), ("cached", {"sem_tokens": toks})):
        trainer = NRTrainer(copy.deepcopy(tiny_model), TTrainConfig(batch_size=2),
                            steps_per_epoch=1, device="cpu")
        trainer.init(seed=0)
        losses = trainer.train_step(gt, r256, r224, **kw)
        out[name] = (float(losses["combined"]),
                     trainer.score_frames(r256, r224, kw.get("sem_tokens")))
    assert np.isfinite(out["direct"][0])
    assert abs(out["cached"][0] - out["direct"][0]) <= ATOL
    np.testing.assert_allclose(out["cached"][1], out["direct"][1], atol=ATOL)


def test_cache_builder_cli_matches_jax(tmp_path):
    # both CLIs over one tree with the same DINOv2-layout checkpoint: the
    # port's cache holds its ViT's fp16 tokens of the canonical renders,
    # the JAX reader reads it, and it equals the JAX tool's cache to fp16
    # rounding of tokens that agree to ~1e-6 (2e-3 + one fp16 ulp)
    data = str(tmp_path / "nr")
    csv = tsynth.make_nr_tree(data, scenes=("chair", "room"), methods=("nerfacto",),
                              frames=3, hw=(64, 80))
    vit = init_vit_(ViTS14(depth=1, grid_size=R224 // 14), torch.Generator().manual_seed(5))
    sd = vit.state_dict()
    sd["pos_embed"] = torch.cat([torch.zeros(1, 1, vit.embed_dim), sd["pos_embed"]], 1)
    ckpt = str(tmp_path / "dinov2.pth")
    torch.save(sd, ckpt)
    common = ["--data-dir", data, "--scores-csv", csv, "--batch-size", "2",
              "--sem-size", str(R224), "--vit-depth", "1", "--num-workers", "0",
              "--vit-ckpt", ckpt]
    assert tcli.main(common + ["--cache-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    jcli.main(common + ["--cache-dir", str(tmp_path / "jax")])
    rows = read_rows(csv)
    from nerf_qa_torch.data.datasets import NerfNRQADataset

    for vid, row in enumerate(rows):
        port_file = tcache.token_cache_path(str(tmp_path / "port"), row["render_dir"])
        jax_file = tcache.token_cache_path(str(tmp_path / "jax"), row["render_dir"])
        got, want = np.load(port_file), np.load(jax_file)
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape == (3, 4, 4, 384)
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                   rtol=2**-10, atol=ATOL)
        with open(port_file + tcache.META_SUFFIX) as f:
            assert json.load(f)["basenames"] == ["000.png", "001.png", "002.png"]
        ds = NerfNRQADataset([row], data, mode="gt", sem_size=R224)
        r224 = np.stack([ds[i][1]["224x224"] for i in range(len(ds))])
        with torch.no_grad():
            direct = vit(torch.from_numpy(r224))["x_norm_patchtokens"]
        np.testing.assert_array_equal(got.reshape(3, 16, 384),
                                      direct.half().numpy())
    reader = jcache.TokenCacheReader(str(tmp_path / "port"), pd.read_csv(csv))
    assert reader.coverage() == (2, 2)
    assert reader.gather(np.array([1]), np.array([2])).shape == (1, 4, 4, 384)
    # a second run skips the cached videos
    mtime = os.path.getmtime(port_file)
    assert tcli.main(common + ["--cache-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert os.path.getmtime(port_file) == mtime


def test_cache_builder_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    csv = tsynth.make_nr_tree(str(tmp_path / "nr"), scenes=("chair",), methods=("nerfacto",),
                              frames=1, hw=(32, 32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data-dir", str(tmp_path / "nr"), "--scores-csv", csv,
                   "--cache-dir", str(tmp_path / "c"), "--vit-depth", "1"])
