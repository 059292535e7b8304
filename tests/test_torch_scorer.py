"""The port's FrameScorer, batched_map and score CLI against the JAX
package on the CPU."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.core import dists as tdists
from nerf_qa_torch.eval import video_scorer as tvs
from nerf_qa_torch.tools.score import main as tscore_main
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.config import DISTSConfig as JConfig
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.eval.video_scorer import FrameScorer as JFrameScorer
from nerf_qa_tpu.tools.score import main as jscore_main
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 256, (5, 90, 120, 3), dtype=np.uint8)
    r = rng.integers(0, 256, (5, 90, 120, 3), dtype=np.uint8)
    return d, r


def _scorer(model, cfg=TConfig(), **kw):
    return tvs.FrameScorer(model, tdists.load_pretrained_weights(), cfg,
                           device="cpu", **kw)


def test_frame_scorer_uint8_matches_jax(jax_params, torch_model, frames):
    # fp32 + eager on both sides, 90x120 uint8 -> 64x64: atol 1e-4
    d, r = frames
    want = JFrameScorer(jax_params, jdists.load_pretrained_weights(),
                        cfg=JConfig(), resize_to=(64, 64)).score_frames(
        d, r, batch_size=2)
    got = _scorer(torch_model, resize_to=(64, 64)).score_frames(d, r, batch_size=2)
    assert got.shape == (5,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_frame_scorer_bf16_serving_config_matches_jax(jax_params, torch_model,
                                                      frames):
    # bf16 fast resize + bf16 pyramid; port with the kernel stats path
    # (its plain version on the CPU), JAX with its default stats. bf16
    # rounds at other places in the two frameworks: atol 5e-3
    d, r = frames
    want = JFrameScorer(jax_params, jdists.load_pretrained_weights(),
                        resize_to=(64, 64)).score_frames(d, r, batch_size=5)
    cfg = TConfig(compute_dtype="bfloat16", stats_impl="kernel")
    got = _scorer(torch_model, cfg, resize_to=(64, 64)).score_frames(
        d, r, batch_size=5)
    gap = float(np.abs(got - want).max())
    print(f"bf16 FrameScorer gap port vs JAX: {gap:.3e}")
    assert gap <= 5e-3


def test_frame_scorer_tail_padding_invariant(torch_model, frames):
    d, r = frames
    scorer = _scorer(torch_model, resize_to=(64, 64))
    np.testing.assert_allclose(scorer.score_frames(d, r, batch_size=2),
                               scorer.score_frames(d, r, batch_size=5), atol=1e-5)


def test_frame_scorer_takes_tensors_and_numpy_alike(torch_model, frames):
    d, r = frames
    scorer = _scorer(torch_model, resize_to=(64, 64))
    np.testing.assert_allclose(
        scorer.score_frames(torch.from_numpy(d), torch.from_numpy(r), batch_size=2),
        scorer.score_frames(d, r, batch_size=2), atol=1e-6)


def test_frame_scorer_video_mean(torch_model):
    scorer = _scorer(torch_model, resize_to=(64, 64))
    d = np.random.default_rng(5).random((3, 64, 64, 3)).astype(np.float32)
    assert abs(scorer.score_video(d, d.copy(), batch_size=3)) < 1e-5
    vids = scorer.score_videos([(d, d.copy()), (d[:2], d[:2].copy())], batch_size=2)
    assert len(vids) == 2 and max(abs(v) for v in vids) < 1e-5


def test_frame_scorer_full_size_float_frames(torch_model):
    d = np.random.default_rng(6).random((2, 48, 40, 3)).astype(np.float32)
    r = np.clip(d + 0.05, 0, 1)
    s = _scorer(torch_model, resize_to=None).score_frames(d, r, batch_size=2)
    assert s.shape == (2,) and (s > 0).all()


def test_frame_scorer_default_cfg_is_the_serving_config(jax_params, torch_model,
                                                        frames):
    # the default takes the moments kernel's route: on CPU tensors that is
    # the plain sums, with no launch; bf16 against JAX's bf16 scorer at 5e-3
    from nerf_qa_torch.ops.cuda import moments

    scorer = tvs.FrameScorer(torch_model, tdists.load_pretrained_weights(),
                             resize_to=(64, 64), device="cpu")
    assert scorer.cfg == TConfig(compute_dtype="bfloat16", stats_impl="kernel")
    before = moments.launches
    d, r = frames
    got = scorer.score_frames(d, r, batch_size=5)
    assert moments.launches == before
    want = JFrameScorer(jax_params, jdists.load_pretrained_weights(),
                        resize_to=(64, 64)).score_frames(d, r, batch_size=5)
    assert float(np.abs(got - want).max()) <= 5e-3


def test_frame_scorer_needs_a_device_without_cuda(torch_model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvs.FrameScorer(torch_model, tdists.load_pretrained_weights())


@pytest.mark.parametrize("kw", [dict(mesh=True), dict(spatial=True),
                                dict(antialias=True)])
def test_frame_scorer_unported_options_raise(jax_params, torch_model, frames, kw):
    if "mesh" in kw:
        # ported since: over a four-device CPU mesh the scores are the JAX
        # scorer's over its four-device mesh (fp32 + eager, 90x120 uint8
        # -> 64x64, batch 5 padded to 8: atol 1e-4)
        import jax

        from nerf_qa_torch.parallel.mesh import create_mesh
        from nerf_qa_tpu.parallel.mesh import create_mesh as jcreate_mesh

        d, r = frames
        want = JFrameScorer(jax_params, jdists.load_pretrained_weights(),
                            cfg=JConfig(), resize_to=(64, 64),
                            mesh=jcreate_mesh(jax.devices()[:4])
                            ).score_frames(d, r, batch_size=5)
        got = tvs.FrameScorer(torch_model, tdists.load_pretrained_weights(), TConfig(),
                              resize_to=(64, 64), mesh=create_mesh(["cpu"] * 4)
                              ).score_frames(d, r, batch_size=5)
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    if "spatial" in kw:
        # ported since: the full-resolution mode needs a mesh, as the JAX
        # scorer's does (tests/test_torch_spatial.py scores with one)
        with pytest.raises(ValueError, match="requires a mesh"):
            _scorer(torch_model, resize_to=None, **kw)
        return
    if "antialias" in kw:
        # ported since: scores as the JAX scorer with antialias=True
        # (fp32 + eager, 90x120 uint8 -> 64x64: atol 1e-4)
        d, r = frames
        want = JFrameScorer(jax_params, jdists.load_pretrained_weights(),
                            cfg=JConfig(), resize_to=(64, 64),
                            **kw).score_frames(d, r, batch_size=5)
        got = _scorer(torch_model, resize_to=(64, 64), **kw).score_frames(
            d, r, batch_size=5)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_frame_count_mismatch_raises(torch_model):
    scorer = _scorer(torch_model, resize_to=None)
    with pytest.raises(ValueError):
        scorer.score_frames(np.zeros((2, 8, 8, 3), np.float32),
                            np.zeros((3, 8, 8, 3), np.float32))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_batched_map_padding_and_edges(kind):
    """Exact multiple, ragged tail and empty input; padded rows never leak."""
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        assert a.shape[0] == 4
        return np.asarray(a.sum(axis=(1, 2)) + b.sum(axis=(1, 2)))

    rng = np.random.default_rng(0)
    a = rng.random((10, 3, 2)).astype(np.float32)
    b = rng.random((10, 3, 2)).astype(np.float32)
    want = a.sum(axis=(1, 2)) + b.sum(axis=(1, 2))
    if kind == "torch":
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tvs.batched_map(fn, (a, b), 4), want, rtol=1e-6)
    assert calls == [4, 4, 4]
    np.testing.assert_allclose(tvs.batched_map(fn, (a[:8], b[:8]), 4), want[:8],
                               rtol=1e-6)
    assert tvs.batched_map(fn, (a[:0], b[:0]), 4).shape == (0,)


def _gradient(h=64, w=64, shift=0.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1)
    return np.clip(img * 0.8 + shift, 0, 1)


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory, jax_params):
    root = tmp_path_factory.mktemp("tscore")
    ref_dir, dist_dir = root / "ref", root / "dist"
    ref_dir.mkdir()
    dist_dir.mkdir()
    rng = np.random.default_rng(8)
    for i in range(3):
        ref = _gradient(shift=0.01 * i)
        dist = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1)
        Image.fromarray((ref * 255).astype(np.uint8)).save(ref_dir / f"{i:03d}.png")
        Image.fromarray((dist * 255).astype(np.uint8)).save(dist_dir / f"{i:03d}.png")
    vgg_npz = str(root / "vgg.npz")
    export_vgg16_to_npz(jax_params, vgg_npz)
    return str(ref_dir), str(dist_dir), vgg_npz


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_score_cli_matches_jax_cli(pair_dirs, capsys):
    # both CLIs on the same frame dirs and the same VGG .npz, --fp32:
    # atol 1e-4 on the video score
    ref_dir, dist_dir, vgg = pair_dirs
    common = ["--ref", ref_dir, "--dist", dist_dir, "--fp32", "--json",
              "--vgg-ckpt", vgg, "--batch-size", "2"]
    want = _run(jscore_main, common, capsys)
    got = _run(tscore_main, common + ["--device", "cpu"], capsys)
    assert got.keys() == want.keys() == {"dists"}
    assert got["dists"]["frames"] == want["dists"]["frames"] == 3
    assert abs(got["dists"]["video_score"] - want["dists"]["video_score"]) <= 1e-4
    assert got["dists"]["video_score"] > 0


def test_score_cli_image_pair_default_path_and_csv(pair_dirs, tmp_path, capsys):
    ref_dir, dist_dir, vgg = pair_dirs
    csv = str(tmp_path / "s.csv")
    out = _run(tscore_main, ["--ref", os.path.join(ref_dir, "000.png"),
                             "--dist", os.path.join(dist_dir, "000.png"),
                             "--vgg-ckpt", vgg, "--json", "--device", "cpu",
                             "--out-csv", csv], capsys)
    assert out["dists"]["frames"] == 1 and 0 < out["dists"]["video_score"] < 1
    lines = open(csv).read().strip().splitlines()
    assert lines[0] == "frame,dists" and len(lines) == 2


@pytest.mark.parametrize("extra", [["--metric", "adists", "--dist", "clip.mov"],
                                   ["--nr", "--nr-ckpt", "."],  # an orbax dir
                                   ["--dist", "clip.mp4"]])
def test_score_cli_unported_modes_exit(pair_dirs, extra):
    # an orbax checkpoint is not ported at all (it needs JAX: ROADMAP's
    # "Not to port"); an mp4 or mov the native demuxer cannot read (here
    # a missing file) needs an ffmpeg backend, and without one raises the
    # JAX package's message
    ref_dir, dist_dir, _ = pair_dirs
    if "--nr" in extra:
        err, match = SystemExit, "Not to port"
    else:
        err, match = RuntimeError, "needs an ffmpeg backend"
    with pytest.raises(err, match=match):
        tscore_main(["--ref", ref_dir, "--dist", dist_dir, "--device", "cpu",
                     *extra])


def test_score_cli_shape_mismatch_exits(pair_dirs, tmp_path):
    ref_dir, _, vgg = pair_dirs
    other = tmp_path / "other"
    other.mkdir()
    Image.fromarray((_gradient(32, 32) * 255).astype(np.uint8)).save(other / "0.png")
    with pytest.raises(SystemExit):
        tscore_main(["--ref", ref_dir, "--dist", str(other), "--fp32",
                     "--vgg-ckpt", vgg, "--device", "cpu"])
