"""The port's convert_video tool against the JAX package's on the CPU (the
extracted frame tree file for file, the --to-mp4 remux byte for byte and
its round trip), and --device cpu smokes of the two feed benchmarks
(bench_host_decode, bench_feed) at tiny sizes, checking their JSON keys."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from nerf_qa_torch.data import native
from nerf_qa_torch.data import video as tvid
from nerf_qa_torch.tools import bench_feed, bench_host_decode
from nerf_qa_torch.tools import convert_video as tconv
from nerf_qa_tpu.tools import convert_video as jconv
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture()
def frame_dir(tmp_path):
    h, w = 72, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = tmp_path / "clip"
    d.mkdir()
    for i in range(3):
        img = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1) * 0.8 + 0.05 * i
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(d / f"{i:02d}.png")
    return str(d)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("sizes", [(256,), (32, 64)])
def test_extract_matches_jax_tree(frame_dir, tmp_path, sizes):
    got_written, got_frames = tconv.extract(frame_dir, str(tmp_path / "port"), sizes,
                                            max_frames=2)
    want_written, want_frames = jconv.extract(frame_dir, str(tmp_path / "jax"), sizes,
                                              max_frames=2)
    assert [os.path.relpath(p, tmp_path / "port") for p in got_written] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want_written]
    np.testing.assert_array_equal(got_frames, want_frames)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 2 * (1 + len(sizes))
    assert got == want


def test_cli_check_prints_psnr(frame_dir, tmp_path, capsys):
    tconv.main(["--video", frame_dir, "--out-dir", str(tmp_path / "o"), "--check"])
    out = capsys.readouterr().out
    assert "original_size" in out and "round-trip PSNR" in out
    assert tconv.psnr(np.zeros(4), np.zeros(4)) == pytest.approx(120.0)


def test_to_mp4_remux_matches_jax_and_round_trips(frame_dir, tmp_path, capsys):
    port_mp4, jax_mp4 = str(tmp_path / "p" / "c.mp4"), str(tmp_path / "j" / "c.mp4")
    tconv.main(["--video", frame_dir, "--to-mp4", port_mp4, "--fps", "12"])
    jconv.main(["--video", frame_dir, "--to-mp4", jax_mp4, "--fps", "12"])
    assert "3 frames" in capsys.readouterr().out
    with open(port_mp4, "rb") as a, open(jax_mp4, "rb") as b:
        assert a.read() == b.read()
    if not native.available():
        pytest.skip(f"native decoder not built: {native.unavailable_reason()}")
    src = tvid.load_video_frames(frame_dir, resize=False)
    back = tvid.load_video_frames(port_mp4, resize=False)
    assert back.shape == src.shape
    np.testing.assert_allclose(back, src, atol=0.04)
    # and the mp4 extracts like its source directory, within JPEG's loss
    written, frames = tconv.extract(port_mp4, str(tmp_path / "x"), (32,))
    assert [os.path.basename(p) for p in written] == ["original_size", "32x32"]
    np.testing.assert_allclose(frames, src, atol=0.04)


def test_bench_host_decode_smoke(tmp_path, capsys):
    assert bench_host_decode.main(["--frames", "2", "--threads", "1,2", "--json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {f"fps_host_decode_{c}_t{t}" for c in ("jpeg", "png") for t in (1, 2)}
    assert keys <= set(res) and all(res[k] > 0 for k in keys)
    assert res["host_cores"] == os.cpu_count()
    assert res["decoder"] == ("native" if native.available() else "pil")
    if native.available():
        assert res["fps_host_decode_jpeg_fast_t1"] > 0
    # the overlapped feed at a toy batch through FrameScorer on the CPU
    paths = bench_host_decode.make_fixtures(str(tmp_path), 2, h=48, w=64)
    assert bench_host_decode.bench_overlapped(paths, 1, batch=2, iters=2,
                                              device="cpu") > 0


def test_bench_feed_tiny_smoke(capsys):
    assert bench_feed.main(["--tiny", "--device", "cpu", "--json"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    res = lines[-1]
    want = {"fps_dists_jpeg", "fps_dists_uint8_cache", "fps_nr_full", "fps_nr_tokens"}
    if native.available():
        want.add("fps_dists_jpeg_fast")
    assert want <= set(res) and all(res[k] > 0 for k in want)
    assert res["frames"] == 16 and res["batch"] == 4 and res["nr_batch"] == 4
    assert res["fixture_hw"] == [96, 128] and res["uint8_cache_build_s"] >= 0
    # cumulative lines: one per finished mode, then the final result
    assert len(lines) == len(want) + 1 and lines[-2] == res
