"""Video frame loading and Motion-JPEG mp4 writing.

Counterpart of ``nerf_qa_tpu/data/video.py``. Reference behaviour:
load_video_frames — OpenCV mp4 decode -> resized frame tensors
(data.py:378-392) and create_test_video_dataloader (data.py:395-405).

mp4s with Motion-JPEG tracks demux and decode natively (the port's
``native/decoder.cpp``: an ISO-BMFF parser and libjpeg, through
``data/native.py``); other codecs (avc1/hev1/...) go to an ffmpeg backend
(imageio-ffmpeg or the ffmpeg binary), and without one the load raises.
``write_mjpeg_mp4`` writes the natively decodable flavour, byte for byte
as the JAX package's writer does, so frame trees round-trip through a
single-file container with no external tools. Frame directories (the
reference datasets' on-disk format) always work.
"""
from __future__ import annotations

import io
import os
import re
import shutil
import struct
import subprocess
from typing import Iterator

import numpy as np

from nerf_qa_torch.data import native
from nerf_qa_torch.data.imaging import (
    fast_decode_enabled,
    load_prepared,
    prepare_image,
)


def _ffmpeg_exe() -> str | None:
    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except (ImportError, RuntimeError):
        return shutil.which("ffmpeg")


def load_video_frames(
    video_path: str,
    resize: bool = True,
    keep_aspect_ratio: bool = False,
    max_frames: int | None = None,
) -> np.ndarray:
    """Decode a video to (T, H, W, 3) float32 frames in [0,1]
    (data.py:378-392 semantics): a directory of .png/.jpg frames sorted
    by name, or an mp4 file (MJPEG natively, other codecs through
    ffmpeg)."""
    if os.path.isdir(video_path):
        files = sorted(
            f for f in os.listdir(video_path) if f.endswith((".png", ".jpg"))
        )
        if max_frames:
            files = files[:max_frames]
        # load_prepared decodes natively when the library builds
        frames = [
            load_prepared(os.path.join(video_path, f), resize=resize,
                          keep_aspect_ratio=keep_aspect_ratio)
            for f in files
        ]
        return np.stack(frames)

    native_frames = _load_mp4_native(video_path, resize, keep_aspect_ratio,
                                     max_frames)
    if native_frames is not None:
        return native_frames

    exe = _ffmpeg_exe()
    if exe is None:
        raise RuntimeError(
            "mp4 decode needs an ffmpeg backend (imageio-ffmpeg or the "
            "ffmpeg binary) for non-MJPEG codecs; none found. Extract "
            "frames to a directory (tools/convert_video.py) and pass the "
            "directory instead, or remux as Motion-JPEG "
            "(data.video.write_mjpeg_mp4) which decodes natively."
        )
    # probe dimensions via ffmpeg, then stream raw RGB frames
    probe = subprocess.run([exe, "-i", video_path], capture_output=True,
                           text=True)
    m = re.search(r"(\d{2,5})x(\d{2,5})", probe.stderr)
    if not m:
        raise RuntimeError(f"could not probe video dimensions: {video_path}")
    w, h = int(m.group(1)), int(m.group(2))
    proc = subprocess.Popen(
        [exe, "-i", video_path, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
    )
    frames = []
    frame_bytes = w * h * 3
    try:
        while True:
            raw = proc.stdout.read(frame_bytes)
            if len(raw) < frame_bytes:
                break
            img = np.frombuffer(raw, np.uint8).reshape(h, w, 3).astype(
                np.float32) / 255.0
            frames.append(prepare_image(img, resize=resize,
                                        keep_aspect_ratio=keep_aspect_ratio))
            if max_frames and len(frames) >= max_frames:
                break
    finally:
        proc.stdout.close()
        proc.wait()
    return np.stack(frames)


def _load_mp4_native(video_path: str, resize: bool, keep_aspect_ratio: bool,
                     max_frames: int | None) -> np.ndarray | None:
    """Decode an MJPEG mp4 through the native demuxer, applying the
    prepare_image resize policy (DISTS_pt.py:210-217) at decode time.
    Returns None when the native layer is unavailable or the container is
    not an MJPEG mp4 it can parse (the caller then tries ffmpeg)."""
    if not native.available():
        return None
    try:
        _, _, h, w = native.mp4_probe(video_path)
        if h == 0:  # parseable container, non-MJPEG codec
            return None
        if resize and min(h, w) > 256:
            if keep_aspect_ratio:
                if h <= w:
                    oh, ow = 256, max(1, round(w * 256 / h))
                else:
                    oh, ow = max(1, round(h * 256 / w)), 256
            else:
                oh, ow = 256, 256
        else:
            oh, ow = h, w
        return native.mp4_decode_frames(
            video_path, oh, ow, max_frames=max_frames or 0,
            fast=fast_decode_enabled(),
        )
    except IOError:
        return None


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int,
              payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)


def write_mjpeg_mp4(path: str, frames: np.ndarray, fps: int = 30,
                    quality: int = 90) -> None:
    """Write (T,H,W,3) frames (uint8 or float in [0,1]) as a Motion-JPEG
    mp4 (one JPEG per sample, one sample per chunk). The result decodes
    through the native demuxer with no ffmpeg/cv2 — the single-file
    counterpart of the reference's frame-directory layout."""
    from PIL import Image

    if frames.dtype != np.uint8:
        frames = np.clip(np.asarray(frames) * 255.0 + 0.5, 0, 255).astype(
            np.uint8
        )
    t, h, w = frames.shape[:3]
    jpegs = []
    for i in range(t):
        buf = io.BytesIO()
        Image.fromarray(frames[i]).save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat = _box(b"mdat", b"".join(jpegs))
    # absolute sample offsets: ftyp + mdat header
    base = len(ftyp) + 8
    offsets = []
    off = base
    for j in jpegs:
        offsets.append(off)
        off += len(j)

    zeros = b"\x00" * 4
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    mvhd = _full_box(
        b"mvhd", 0, 0,
        zeros * 2 + struct.pack(">II", 1000, t * 1000 // fps)
        + struct.pack(">I", 0x10000) + struct.pack(">H", 0x100)
        + b"\x00" * 10 + matrix + b"\x00" * 24 + struct.pack(">I", 2),
    )
    tkhd = _full_box(
        b"tkhd", 0, 3,
        zeros * 2 + struct.pack(">I", 1) + zeros
        + struct.pack(">I", t * 1000 // fps) + zeros * 2
        + struct.pack(">HHHH", 0, 0, 0, 0) + matrix
        + struct.pack(">II", w << 16, h << 16),
    )
    mdhd = _full_box(
        b"mdhd", 0, 0,
        zeros * 2 + struct.pack(">II", fps, t)
        + struct.pack(">HH", 0x55C4, 0),  # language 'und'
    )
    hdlr = _full_box(
        b"hdlr", 0, 0,
        zeros + b"vide" + zeros * 3 + b"VideoHandler\x00",
    )
    # visual sample entry 'jpeg': baseline MJPEG needs no codec config box
    entry = (
        b"\x00" * 6 + struct.pack(">H", 1)  # data_reference_index
        + b"\x00" * 16
        + struct.pack(">HH", w, h)
        + struct.pack(">II", 0x480000, 0x480000)  # 72 dpi
        + zeros + struct.pack(">H", 1)  # frame_count
        + b"\x00" * 32  # compressorname
        + struct.pack(">Hh", 24, -1)  # depth, pre_defined
    )
    stsd = _full_box(b"stsd", 0, 0,
                     struct.pack(">I", 1) + _box(b"jpeg", entry))
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, t, 1))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full_box(
        b"stsz", 0, 0,
        struct.pack(">II", 0, t)
        + b"".join(struct.pack(">I", len(j)) for j in jpegs),
    )
    stco = _full_box(
        b"stco", 0, 0,
        struct.pack(">I", t)
        + b"".join(struct.pack(">I", o) for o in offsets),
    )
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    dref = _full_box(
        b"dref", 0, 0,
        struct.pack(">I", 1) + _full_box(b"url ", 0, 1, b""),
    )
    dinf = _box(b"dinf", dref)
    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    trak = _box(b"trak", tkhd + mdia)
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)


def iter_video_batches(
    dist_frames: np.ndarray, ref_frames: np.ndarray, batch_size: int
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Fixed-order batch iterator over a frame pair stack
    (create_test_video_dataloader semantics, data.py:395-405)."""
    for lo in range(0, len(dist_frames), batch_size):
        yield dist_frames[lo:lo + batch_size], ref_frames[lo:lo + batch_size]
