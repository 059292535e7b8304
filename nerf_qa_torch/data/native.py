"""The native decode/resize library: its build and its ctypes bindings.

Counterpart of ``nerf_qa_tpu/data/native.py``. The C++ layer
(``nerf_qa_torch/native/decoder.cpp``, the port's own copy) decodes PNG
and JPEG with libpng/libjpeg, composites RGBA onto white, resizes with
torch's bilinear geometry and demuxes Motion-JPEG mp4s, in an in-process
thread pool that writes float32 NHWC batches into numpy buffers.

The library is compiled with ``g++`` at first use, never at import, into
``build/native/`` under the repository root, one file per hash of the
source and flags (a changed source builds anew). Concurrent first uses
(test workers, loader processes) take an ``fcntl`` lock on
``build/native/lock``; the one holding it compiles to a temporary name
and renames the result into place, the others then load it. A failed
build (no g++, or no ``jpeglib.h``/``png.h``/``zlib.h``) is remembered for
the process: :func:`available` returns False and
:func:`unavailable_reason` holds the compiler's stderr. Nothing is
printed.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "native" / "decoder.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "native"
# the flags of the JAX package's native/build.sh, and no fused multiply-add
# (the resize rounds as the PIL route's numpy resize does)
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failure: str | None = None


def source_hash() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return h.hexdigest()[:16]


def build(build_dir: Path) -> Path:
    """Compile the decoder into ``build_dir`` unless this source's library
    is there; return its path. Raises RuntimeError with g++'s stderr."""
    build_dir = Path(build_dir)
    lib_path = build_dir / f"libnqa_decoder-{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native decoder is "
                           "compiled from nerf_qa_torch/native/decoder.cpp")
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib_path.exists():  # another process built it while we waited
            return lib_path
        tmp = build_dir / f"{lib_path.name}.{os.getpid()}"
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"$ {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    cp, ci = ctypes.c_char_p, ctypes.c_int
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    cpp = ctypes.POINTER(ctypes.c_char_p)
    # the functions called here (the "2" forms take the fast flag; the
    # library's forms without it are the same calls with fast = 0)
    for name, args in (
            ("nqa_decode_resize2", [cp, fp, ci, ci, ci]),
            ("nqa_image_size", [cp, ip, ip]),
            ("nqa_decode_resize_batch2", [cpp, ci, fp, ci, ci, ci, ci]),
            ("nqa_mp4_probe", [cp, cp, ip, ip, ip]),
            ("nqa_mp4_decode_frames2", [cp, ci, ci, fp, ci, ci, ci, ci])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci


def _load() -> ctypes.CDLL:
    """Build if needed and load the library once per process; raise
    RuntimeError (the remembered reason) when it cannot be built."""
    global _lib, _failure
    with _lock:
        if _lib is None and _failure is None:
            try:
                lib = ctypes.CDLL(str(build(BUILD_DIR)))
                _declare(lib)
                _lib = lib
            except (RuntimeError, OSError) as e:
                _failure = str(e)
        if _lib is None:
            raise RuntimeError(f"native decoder unavailable: {_failure}")
        return _lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def unavailable_reason() -> str | None:
    """Why the library could not be built or loaded (None if it was, or
    if no build was tried yet)."""
    return _failure


def fast_decode_available() -> bool:
    """True when the library exports the DCT-scaled fast-decode ABI: the
    port's own build always does, so this is :func:`available`."""
    return available()


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def image_size(path: str) -> tuple[int, int]:
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.nqa_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"decode failed: {path}")
    return h.value, w.value


def decode_resize(path: str, out_h: int, out_w: int,
                  fast: bool = False) -> np.ndarray:
    """Decode + bilinear resize to float32 (out_h, out_w, 3) in [0,1];
    RGBA composites onto white (matches data/imaging.load_image_rgb).
    fast=True permits a DCT-scaled JPEG decode (the largest 1/{2,4,8}
    that still covers the target). The DCT scale antialiases where the
    full-resolution bilinear path aliases: see
    data/imaging.fast_decode_enabled. PNG is unaffected."""
    lib = _load()
    out = np.empty((out_h, out_w, 3), np.float32)
    if lib.nqa_decode_resize2(path.encode(), _fptr(out), out_h, out_w,
                              int(fast)):
        raise IOError(f"decode failed: {path}")
    return out


def decode_resize_batch(paths: list[str], out_h: int, out_w: int,
                        threads: int = 8, fast: bool = False) -> np.ndarray:
    """Parallel decode+resize into one (N, out_h, out_w, 3) f32 batch on a
    pool of ``threads`` threads."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.nqa_decode_resize_batch2(arr, n, _fptr(out), out_h, out_w,
                                            threads, int(fast))
    if failures:
        raise IOError(f"{failures}/{n} decodes failed")
    return out


def mp4_probe(path: str) -> tuple[str, int, int, int]:
    """Probe an mp4's video track: (codec fourcc, n_frames, h, w).
    h/w are 0 for codecs the native layer can't decode (non-MJPEG)."""
    lib = _load()
    codec = ctypes.create_string_buffer(5)
    n = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.nqa_mp4_probe(path.encode(), codec, ctypes.byref(n),
                         ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"no parseable video track: {path}")
    return codec.value.decode("latin-1"), n.value, h.value, w.value


def mp4_decode_frames(path: str, out_h: int, out_w: int, start: int = 0,
                      max_frames: int = 0, threads: int = 8,
                      fast: bool = False) -> np.ndarray:
    """Decode an MJPEG mp4's samples [start, start+max_frames) into a
    (T, out_h, out_w, 3) float32 batch (parallel across the pool).
    Raises for non-MJPEG codecs — callers fall back to ffmpeg."""
    lib = _load()
    codec, total, _, _ = mp4_probe(path)
    n = total - start if max_frames <= 0 else min(max_frames, total - start)
    n = max(n, 0)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    rc = lib.nqa_mp4_decode_frames2(path.encode(), start, n, _fptr(out),
                                    out_h, out_w, threads, int(fast))
    if rc == -2:
        raise IOError(f"unsupported mp4 codec '{codec}': {path}")
    if rc < 0 or rc != n:
        raise IOError(f"mp4 decode failed (rc={rc}): {path}")
    return out
