"""Explicit config dataclasses, and the device rule of every entry point.

Counterpart of ``nerf_qa_tpu/config.py`` (a copy, not an import). This
slice carries ``DISTSConfig`` only; the other configs come with their
slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DISTSConfig:
    """DISTS metric configuration (covers the reference's three variants).

    variant='main'     -> DISTS_pt.py       (raw α/β, joint-sum norm)
    variant='original' -> DISTS_pt_original (clamped load, norm modes)
    variant='softmax'  -> DISTS_pt_softmax  (α/β stored as logits)
    """

    variant: str = "main"
    # '+'-combinable tokens: 'relu', 'w_sum_detach'
    # (DISTS_pt_original.py:111-119); ignored by variant='softmax'.
    weight_norm: str = ""
    detach_beta: bool = False
    # load-time clamping for variant='original' (DISTS_pt_original.py:69-72)
    weight_lower_bound: float = 0.0
    alpha_beta_ratio: float = 1.0
    # execution knobs (no reference equivalent)
    compute_dtype: str = "float32"  # 'bfloat16' for tensor-core convs
    # 'eager' (two-pass oracle) | 'kernel' (fused CUDA moments)
    stats_impl: str = "eager"
    c1: float = 1e-6
    c2: float = 1e-6

    def replace(self, **kw) -> "DISTSConfig":
        return dataclasses.replace(self, **kw)


@contextlib.contextmanager
def true_fp32():
    """Run fp32 convolutions and matmuls in full fp32 inside the block.

    cuDNN takes fp32 convolutions through TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; the fp32 parity path must not. The flags are set here,
    locally, and restored on exit; importing the package flips nothing.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16, anything else -> torch.float32 (the
    JAX package's reading of ``compute_dtype``)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. With no CUDA and no explicit device this raises; it never
    carries on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: nerf_qa_torch runs on the GPU unless the caller "
            "passes device='cpu' (--device cpu on the command line)")
    return torch.device("cuda")
