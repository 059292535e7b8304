"""The port's native decoder (nerf_qa_torch/native/decoder.cpp, built with
g++ at first use) against the JAX package's PIL route on the CPU, at the
tolerances of tests/test_native_decoder.py: PNG 1e-6, resize 1e-5, JPEG
2.5/255, RGBA on white 1/255. The port's copy rounds as the PIL route
does, so PNG and JPEG frames of the loaders come out bit-equal. Also: the
loaders' native route and its counted PIL fallback, two processes
building into one fresh directory, and a failed build's recorded reason.
Every test that needs the library skips with that reason without it."""
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from nerf_qa_torch.data import imaging as timg
from nerf_qa_torch.data import native
from nerf_qa_tpu.data import imaging as jimg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def lib():
    if not native.available():
        pytest.skip(f"native decoder not built: {native.unavailable_reason()}")


@pytest.fixture()
def png_path(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(arr).save(p)
    return str(p)


@pytest.fixture()
def jpg_path(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    p = tmp_path / "img.jpg"
    Image.fromarray(arr).save(p, quality=95)
    return str(p)


@pytest.fixture()
def big_jpg_path(tmp_path):
    """512x768 smooth gradient + mild texture: fast decode picks a 1/2 DCT
    scale for a 256² target."""
    h, w = 512, 768
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1) * 0.8
    rng = np.random.default_rng(2)
    img = np.clip(img + rng.normal(0.1, 0.03, (h, w, 3)), 0, 1)
    p = tmp_path / "big.jpg"
    Image.fromarray((img * 255).astype(np.uint8)).save(p, quality=92)
    return str(p)


def test_image_size(lib, png_path, jpg_path):
    assert native.image_size(png_path) == (48, 64)
    assert native.image_size(jpg_path) == (40, 56)


def test_png_decode_matches_jax_pil(lib, png_path):
    got = native.decode_resize(png_path, 48, 64)
    np.testing.assert_allclose(got, jimg.load_image_rgb(png_path), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(32, 32), (20, 90), (96, 128)])
def test_png_resize_matches_jax_host_resize(lib, png_path, out_hw):
    got = native.decode_resize(png_path, *out_hw)
    want = jimg.resize_image(jimg.load_image_rgb(png_path), *out_hw)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_jpeg_decode_matches_jax_pil(lib, jpg_path):
    got = native.decode_resize(jpg_path, 40, 56)
    # JPEG decoders may differ by a few LSBs in IDCT rounding
    assert np.abs(got - jimg.load_image_rgb(jpg_path)).max() <= 2.5 / 255


def test_rgba_white_composite(lib, tmp_path):
    arr = np.zeros((8, 8, 4), np.uint8)
    arr[..., 0] = 200
    arr[..., 3] = 128  # half transparent red
    p = tmp_path / "rgba.png"
    Image.fromarray(arr, "RGBA").save(p)
    got = native.decode_resize(str(p), 8, 8)
    np.testing.assert_allclose(got, jimg.load_image_rgb(str(p)),
                               atol=1 / 255 + 1e-6)


def test_batch_decode(lib, png_path, jpg_path):
    batch = native.decode_resize_batch([png_path, jpg_path, png_path], 32, 32,
                                       threads=3)
    assert batch.shape == (3, 32, 32, 3)
    single = native.decode_resize(png_path, 32, 32)
    np.testing.assert_allclose(batch[0], single, atol=1e-6)
    np.testing.assert_allclose(batch[2], single, atol=1e-6)
    np.testing.assert_allclose(batch[1], native.decode_resize(jpg_path, 32, 32),
                               atol=1e-6)


@pytest.mark.parametrize("threads", [1, 2, 5])
def test_batch_threads_give_the_same_frames(lib, png_path, jpg_path, threads):
    # each thread count runs on its own pool; the frames do not depend on it
    paths = [png_path, jpg_path] * 3
    got = native.decode_resize_batch(paths, 24, 40, threads=threads)
    want = np.stack([jimg.resize_image(jimg.load_image_rgb(p), 24, 40)
                     for p in paths])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_missing_file_raises(lib, tmp_path):
    with pytest.raises(IOError):
        native.decode_resize(str(tmp_path / "nope.png"), 16, 16)
    with pytest.raises(IOError):
        native.decode_resize_batch([str(tmp_path / "nope.jpg")], 16, 16)
    with pytest.raises(IOError):
        native.image_size(str(tmp_path / "nope.png"))


def test_fast_decode_available(lib):
    assert native.fast_decode_available()


def test_fast_jpeg_close_to_exact(lib, big_jpg_path):
    exact = native.decode_resize(big_jpg_path, 256, 256)
    fast = native.decode_resize(big_jpg_path, 256, 256, fast=True)
    # a different downsample (DCT-domain 1/2 then bilinear vs direct
    # bilinear) of the same content: small mean delta
    diff = np.abs(fast - exact)
    assert diff.mean() < 0.01, diff.mean()
    assert diff.max() < 0.15, diff.max()


def test_fast_noop_when_no_downscale(lib, jpg_path):
    # 40x56 -> 40x56: no 1/d scale covers the target, so the fast path
    # takes the identical full decode
    np.testing.assert_array_equal(native.decode_resize(jpg_path, 40, 56, fast=True),
                                  native.decode_resize(jpg_path, 40, 56))


def test_fast_png_identical(lib, png_path):
    np.testing.assert_array_equal(native.decode_resize(png_path, 32, 32, fast=True),
                                  native.decode_resize(png_path, 32, 32))


def test_fast_batch(lib, big_jpg_path, png_path):
    batch = native.decode_resize_batch([big_jpg_path, png_path], 256, 256,
                                       threads=2, fast=True)
    assert batch.shape == (2, 256, 256, 3)
    single = native.decode_resize(big_jpg_path, 256, 256, fast=True)
    np.testing.assert_allclose(batch[0], single, atol=1e-6)


@pytest.mark.parametrize("hw", [(300, 420), (120, 96)])
@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_loaders_take_the_native_route_with_the_pil_numbers(lib, tmp_path, hw, ext):
    # load_prepared (square-256 policy) and load_resized against the JAX
    # package's PIL route: equal bits, and no fallback taken
    rng = np.random.default_rng(hw[0])
    p = str(tmp_path / f"f.{ext}")
    Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(p)
    before = timg.pil_fallbacks
    np.testing.assert_array_equal(timg.load_prepared(p), jimg.load_prepared(p))
    np.testing.assert_array_equal(timg.load_resized(p, 64, 80),
                                  jimg.load_resized(p, 64, 80))
    assert timg.pil_fallbacks == before


def test_native_error_falls_back_to_pil_and_is_counted(lib, tmp_path):
    # a PNG under a .jpg name: the native layer (by extension) fails, PIL
    # (by content) reads it, and the fallback is counted
    rng = np.random.default_rng(3)
    p = str(tmp_path / "png_bytes.jpg")
    Image.fromarray(rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)).save(
        p, format="PNG")
    before = timg.pil_fallbacks
    np.testing.assert_array_equal(timg.load_prepared(p), jimg.load_prepared(p))
    np.testing.assert_array_equal(timg.load_resized(p, 32, 32),
                                  jimg.load_resized(p, 32, 32))
    assert timg.pil_fallbacks == before + 2


def test_fast_decode_env_switch(monkeypatch):
    monkeypatch.delenv("NERF_QA_TORCH_FAST_DECODE", raising=False)
    assert not timg.fast_decode_enabled()
    monkeypatch.setenv("NERF_QA_TORCH_FAST_DECODE", "1")
    assert timg.fast_decode_enabled()


def test_two_processes_build_one_fresh_directory(tmp_path):
    # both compile-or-wait on the lock at once; both load the one library,
    # and nothing else is left in the directory
    if not native.available():
        pytest.skip(f"native decoder not built: {native.unavailable_reason()}")
    build_dir = tmp_path / "native"
    code = f"""
import ctypes, sys
from pathlib import Path
from nerf_qa_torch.data import native
lib = native.build(Path({str(build_dir)!r}))
h, w = ctypes.c_int(), ctypes.c_int()
rc = ctypes.CDLL(str(lib)).nqa_image_size(sys.argv[1].encode(), ctypes.byref(h), ctypes.byref(w))
print(lib, rc, h.value, w.value)
"""
    img = tmp_path / "x.png"
    Image.fromarray(np.zeros((5, 7, 3), np.uint8)).save(img)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(img)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1, lines
    lib_path, rc, h, w = lines.pop().split()
    assert (rc, h, w) == ("0", "5", "7")
    assert sorted(os.listdir(build_dir)) == sorted([os.path.basename(lib_path), "lock"])


def test_failed_build_records_the_reason(tmp_path, monkeypatch):
    # a source that needs a missing header, then no g++ at all: build
    # raises with the reason, and the module remembers it
    src = tmp_path / "broken.cpp"
    src.write_text("#include <no_such_header_nqa.h>\nint f() { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    if native.shutil.which("g++") is not None:
        with pytest.raises(RuntimeError, match="no_such_header_nqa"):
            native.build(tmp_path / "out")
        assert not native.available()
        assert "no_such_header_nqa" in native.unavailable_reason()
        assert not native.fast_decode_available()
        assert not os.path.exists(tmp_path / "out" / f"libnqa_decoder-{native.source_hash()}.so")
        with pytest.raises(RuntimeError, match="no_such_header_nqa"):
            native.image_size(str(tmp_path / "x.png"))
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert "g++ not found" in native.unavailable_reason()
