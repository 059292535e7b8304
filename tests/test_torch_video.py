"""The port's data/video.py against the JAX package's on the CPU: the
Motion-JPEG writer byte for byte, the native demuxer (probe, round trip,
max_frames, start offset), the resize policies against per-sample PIL
decode and the JAX package's prepare_image, the non-MJPEG error, frame
directories, and the mp4 route of create_test_video_dataloader and
nr_benchmark.load_render_frames. The JAX package's native decoder is not
built here, so its side reads the same JPEG samples from frame
directories through PIL."""
import io

import numpy as np
import pytest
from PIL import Image

from nerf_qa_torch.data import factories as tfac
from nerf_qa_torch.data import native
from nerf_qa_torch.data import video as tvid
from nerf_qa_torch.eval import nr_benchmark as tbench
from nerf_qa_tpu.data import imaging as jimg
from nerf_qa_tpu.data import video as jvid
from nerf_qa_tpu.eval import nr_benchmark as jbench


@pytest.fixture()
def lib():
    if not native.available():
        pytest.skip(f"native decoder not built: {native.unavailable_reason()}")


def _gradient_video(t=5, h=64, w=80, seed=0, noise=0.02):
    """Smooth frames plus a little seeded texture."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    frames = np.stack([
        np.stack([(yy / h) * 0.8 + i * 0.02, (xx / w) * 0.8,
                  ((yy + xx) / (h + w)) * 0.8], axis=-1)
        + rng.normal(0, noise, (h, w, 3))
        for i in range(t)
    ])
    return np.clip(frames, 0, 1).astype(np.float32)


def _u8(frames):
    # write_mjpeg_mp4's own float -> uint8 conversion
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _jpeg_dir(path, frames, quality=90):
    """The mp4's samples as a frame directory (PIL writes the same JPEG
    bytes the muxer stores)."""
    path.mkdir(parents=True)
    for i, f in enumerate(_u8(frames)):
        Image.fromarray(f).save(path / f"{i:03d}.jpg", quality=quality)
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("vid")
    frames = _gradient_video(noise=0.0)  # smooth: a tight JPEG round trip
    path = str(root / "clip.mp4")
    tvid.write_mjpeg_mp4(path, frames, fps=10, quality=95)
    return path, frames, _jpeg_dir(root / "clip_jpg", frames, quality=95)


@pytest.mark.parametrize("kind", ["float", "uint8"])
@pytest.mark.parametrize("fps,quality", [(30, 90), (10, 75)])
def test_writer_bytes_equal_jax(tmp_path, kind, fps, quality):
    frames = _gradient_video(t=3, h=40, w=56, seed=1)
    if kind == "uint8":
        frames = _u8(frames)
    tvid.write_mjpeg_mp4(str(tmp_path / "t.mp4"), frames, fps=fps, quality=quality)
    jvid.write_mjpeg_mp4(str(tmp_path / "j.mp4"), frames, fps=fps, quality=quality)
    assert (tmp_path / "t.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()


def test_probe(lib, clip):
    assert native.mp4_probe(clip[0]) == ("jpeg", 5, 64, 80)


def test_roundtrip_content(lib, clip):
    path, frames, jpg_dir = clip
    got = tvid.load_video_frames(path, resize=False)
    assert got.shape == (5, 64, 80, 3)
    np.testing.assert_allclose(got, frames, atol=0.04)
    # the same JPEG samples through the JAX package's PIL route
    np.testing.assert_allclose(got, jvid.load_video_frames(jpg_dir, resize=False),
                               atol=2.5 / 255)


def test_max_frames_and_start_offset(lib, clip):
    path = clip[0]
    assert tvid.load_video_frames(path, resize=False, max_frames=2).shape == (2, 64, 80, 3)
    full = native.mp4_decode_frames(path, 64, 80)
    tail = native.mp4_decode_frames(path, 64, 80, start=3)
    assert tail.shape == (2, 64, 80, 3)
    np.testing.assert_array_equal(tail, full[3:])
    np.testing.assert_array_equal(native.mp4_decode_frames(path, 64, 80, start=1,
                                                           max_frames=2), full[1:3])


@pytest.mark.parametrize("hw", [(320, 400), (400, 300), (200, 240)])
@pytest.mark.parametrize("resize,keep", [(True, False), (True, True), (False, False)])
def test_resize_policies_match_pil_plus_prepare_image(lib, tmp_path, hw, resize, keep):
    # prepare_image semantics at decode time: shortest side > 256 resizes
    # to 256² (or aspect-kept), otherwise the source size
    frames = _gradient_video(t=2, h=hw[0], w=hw[1], seed=2)
    path = str(tmp_path / "v.mp4")
    tvid.write_mjpeg_mp4(path, frames)
    got = tvid.load_video_frames(path, resize=resize, keep_aspect_ratio=keep)
    want = np.stack([
        jimg.prepare_image(np.asarray(Image.open(io.BytesIO(_jpeg_bytes(f))),
                                      np.float32) / 255.0,
                           resize=resize, keep_aspect_ratio=keep)
        for f in _u8(frames)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2.5 / 255)


def _jpeg_bytes(frame_u8, quality=90):
    buf = io.BytesIO()
    Image.fromarray(frame_u8).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_non_mjpeg_mp4_without_ffmpeg_raises(lib, tmp_path, monkeypatch):
    # the same container with an avc1 sample entry: the probe reports no
    # size, the native decode refuses the codec, and without an ffmpeg
    # backend the load raises the JAX package's message
    path = tmp_path / "clip.mp4"
    tvid.write_mjpeg_mp4(str(path), _gradient_video(t=2))
    data = path.read_bytes()
    assert data.count(b"jpeg") == 1
    path.write_bytes(data.replace(b"jpeg", b"avc1"))
    assert native.mp4_probe(str(path)) == ("avc1", 2, 0, 0)
    with pytest.raises(IOError, match="unsupported mp4 codec 'avc1'"):
        native.mp4_decode_frames(str(path), 64, 80)
    monkeypatch.setattr(tvid, "_ffmpeg_exe", lambda: None)
    with pytest.raises(RuntimeError, match="needs an ffmpeg backend"):
        tvid.load_video_frames(str(path))
    with pytest.raises(RuntimeError, match="needs an ffmpeg backend"):
        tvid.load_video_frames(str(tmp_path / "missing.mp4"))


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("resize,keep,max_frames", [(True, False, None), (True, True, 2),
                                                    (False, False, None)])
def test_frame_directories_match_jax(tmp_path, ext, resize, keep, max_frames):
    frames = _u8(_gradient_video(t=3, h=300, w=270, seed=3))
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"{i:03d}.{ext}")
    (tmp_path / "notes.txt").write_text("not a frame")
    got = tvid.load_video_frames(str(tmp_path), resize, keep, max_frames)
    want = jvid.load_video_frames(str(tmp_path), resize, keep, max_frames)
    np.testing.assert_array_equal(got, want)


def test_iter_video_batches_matches_jax():
    d = np.arange(7 * 2).reshape(7, 2).astype(np.float32)
    r = -d
    got = list(tvid.iter_video_batches(d, r, 3))
    want = list(jvid.iter_video_batches(d, r, 3))
    assert len(got) == len(want) == 3
    for (gd, gr), (wd, wr) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gr, wr)


def test_test_video_dataloader_reads_mp4s(lib, tmp_path):
    ref = _gradient_video(t=3, h=288, w=320, seed=4)
    dist = np.clip(ref + 0.05, 0, 1)
    for sub, name, frames in (("Reference", "r.mp4", ref),
                              ("NeRF-QA_videos", "d.mp4", dist)):
        (tmp_path / sub).mkdir()
        tvid.write_mjpeg_mp4(str(tmp_path / sub / name), frames)
        _jpeg_dir(tmp_path / "jpg" / name, frames)
    row = {"reference_filename": "r.mp4", "distorted_filename": "d.mp4"}
    got_d, got_r = tfac.create_test_video_dataloader(row, str(tmp_path))
    assert got_d.shape == got_r.shape == (3, 256, 256, 3)
    np.testing.assert_array_equal(got_d, jvid.load_video_frames(str(tmp_path / "jpg" / "d.mp4")))
    np.testing.assert_array_equal(got_r, jvid.load_video_frames(str(tmp_path / "jpg" / "r.mp4")))


def test_nr_benchmark_loads_render_mp4(lib, tmp_path):
    # the reference layout: NeRF-QA_videos/<name>.mp4; the JAX side reads
    # the same JPEGs from a frame directory named after the video
    frames = _gradient_video(t=3, h=96, w=128, seed=5)
    (tmp_path / "NeRF-QA_videos").mkdir()
    tvid.write_mjpeg_mp4(str(tmp_path / "NeRF-QA_videos" / "v1.mp4"), frames)
    jax_root = tmp_path / "jax"
    _jpeg_dir(jax_root / "NeRF-QA_videos" / "v1", frames)
    row = {"distorted_filename": "v1.mp4"}
    got = tbench.load_render_frames(str(tmp_path), row, max_frames=2,
                                    render_size=64, sem_size=56)
    want = jbench.load_render_frames(str(jax_root), row, max_frames=2,
                                     render_size=64, sem_size=56)
    for g, w in zip(got, want, strict=True):
        assert g.shape[0] == 2
        np.testing.assert_array_equal(g, w)
