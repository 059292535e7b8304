"""Build and load the port's CUDA kernels.

Every ``.cu`` file in ``nerf_qa_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one process per source, all started together, and
linked into one shared library with a plain C interface:
``build/kernels/libnerf_qa_torch.so`` under the repository root. The
library is rebuilt when the hash of the sources changes and loaded with
``ctypes``. Nothing is built when this module is imported: the first
kernel launch calls :func:`load_library`. A failed build raises with
nvcc's stderr; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
LIB_NAME = "libnerf_qa_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from nerf_qa_torch/csrc at first use")
    return found


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    failures = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library unless an up-to-date one
    exists; return its path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = sources_hash()
    if (not force and lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())  # per-process names: concurrent builds never clash
    objects = []
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objects.append(obj)
    _run(procs)
    tmp_lib = BUILD_DIR / f"{LIB_NAME}.{tag}"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objects), "-o", str(tmp_lib)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    for obj in objects:
        obj.unlink()
    os.replace(tmp_lib, lib_path)
    stamp.write_text(digest + "\n")
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and declare
    the argument types of its C functions."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.nqt_moment_sums.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                            ci, ci, ci, ci, ci, vp]
            lib.nqt_moment_sums.restype = ci
            lib.nqt_channel_norm.argtypes = [vp, vp, vp, vp, ci, ci,
                                             ctypes.c_float, ci, ci, ci, vp]
            lib.nqt_channel_norm.restype = ci
            lib.nqt_jbu_filter.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                           ci, ci, vp]
            lib.nqt_jbu_filter.restype = ci
            lib.nqt_error_string.argtypes = [ci]
            lib.nqt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C function returned a CUDA error."""
    if code != 0:
        msg = lib.nqt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
