"""The VGG pyramid's elementwise epilogues: the CUDA kernel's wrapper and
its plain version.

Replaces no Pallas kernel: on the TPU, XLA fused these ops into the
convolutions. Between two cuDNN convolutions of the pyramid each chain of
elementwise ops becomes one pass over device memory
(``csrc/vgg_epilogue.cu``):

- :func:`bias_relu`: ``h = relu(y + b)`` in place over a conv output,
  and with ``square`` also ``h²``, the input of the next stage's L2 pool;
- :func:`pool_root`: ``sqrt(p + 1e-12)`` in place over the L2 pool's
  depthwise conv output.

The passes are bounded by device memory (47.8 GB a 1080p batch of 8 pairs);
the design answers that with 16-byte streaming loads and stores, a thread
whose channels never change (its bias stays in registers) and no
intermediate in device memory.

Numerics equal the plain versions bit for bit, in bf16 and in fp32: each
sum is taken in fp32 and rounded once to the flow dtype where PyTorch's
``add_`` rounds it, the ReLU is ``clamp_min`` (NaN passes), the square is
that of the rounded ``h``, and ``sqrtf`` is correctly rounded.

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise. Where a gradient is recorded, both ops go through
``torch.autograd.Function``s whose backward is plain PyTorch (the rules of
``relu_`` and ``sqrt_``), and the squares are not folded in; the backbone
is frozen, so a bias that requires grad raises.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

# Launches of the CUDA kernels (17 per pyramid forward on the card: 13
# bias-ReLU passes and 4 pool epilogues).
launches = 0

THREADS = 256
# resident blocks an SM the grid is sized for (the loop strides over the rest)
BLOCKS_PER_SM = 4
EPS = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)


class LaunchPlan(NamedTuple):
    vec: int  # values per access: one 16-byte access, or 1
    blocks: int  # grid; blocks·THREADS is a multiple of ``row_vecs``
    row_vecs: int  # accesses a channels_last row spans (1 off the row path)


def _plan(nvals: int, run: int, itemsize: int, aligned: bool, sms: int,
          rows: bool) -> LaunchPlan:
    """The vector is 16 bytes when the pointer is aligned and ``run`` (the
    values no access may cross: C on the row path, a plane's H·W on the
    plane path, the whole buffer for the pool) is a multiple of it. The
    grid fills ``sms`` SMs at most and, on the row path, its stride is a
    multiple of the row's accesses, so each thread keeps its channels."""
    vec = 16 // itemsize
    if not aligned or run % vec:
        vec = 1
    nvec = nvals // vec
    row_vecs = run // vec if rows else 1
    blocks = max(1, min(math.ceil(nvec / THREADS), sms * BLOCKS_PER_SM))
    step = row_vecs // math.gcd(THREADS, row_vecs)
    return LaunchPlan(vec, math.ceil(blocks / step) * step, row_vecs)


@functools.lru_cache(maxsize=256)
def bias_relu_plan(numel: int, c: int, inner: int, itemsize: int,
                   aligned: bool, sms: int) -> LaunchPlan:
    """Plan of one bias-ReLU pass over a (N, C, H, W) map of ``numel``
    values, ``inner`` = 1 in channels_last memory, H·W in NCHW memory."""
    if inner == 1:
        return _plan(numel, c, itemsize, aligned, sms, rows=True)
    return _plan(numel, inner, itemsize, aligned, sms, rows=False)


@functools.lru_cache(maxsize=256)
def pool_root_plan(numel: int, itemsize: int, aligned: bool, sms: int) -> LaunchPlan:
    """Plan of one pool epilogue over ``numel`` values."""
    return _plan(numel, numel, itemsize, aligned, sms, rows=False)


def bias_relu_plain(y: torch.Tensor, bias: torch.Tensor, *, square: bool = False):
    """Plain PyTorch version: ``y.add_(b).relu_()`` (and ``h * h``)."""
    h = y.add_(bias.to(y.dtype).view(1, -1, 1, 1)).relu_()
    return (h, h * h) if square else h


def pool_root_plain(p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``p.add_(1e-12).sqrt_()``."""
    return p.add_(EPS).sqrt_()


def _inner(t: torch.Tensor) -> int:
    """1 for a channels_last map, H·W for an NCHW-contiguous one."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    if t.is_contiguous():
        return t.shape[2] * t.shape[3]
    raise ValueError(f"need a contiguous map (channels_last or NCHW), got "
                     f"strides {t.stride()} for shape {tuple(t.shape)}")


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what}: need bfloat16 or float32, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")


def _recording(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _launch_bias_relu(y: torch.Tensor, bias: torch.Tensor,
                      sq: torch.Tensor | None) -> None:
    global launches
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    c = y.shape[1]
    inner = _inner(y)
    # the bias is read value by value, so only y and sq need aligning
    aligned = y.data_ptr() % 16 == 0 and (sq is None or sq.data_ptr() % 16 == 0)
    plan = bias_relu_plan(y.numel(), c, inner, y.element_size(), aligned,
                          build.sm_count(y.device))
    with torch.cuda.device(y.device):
        code = lib.nqt_bias_relu(
            y.data_ptr(), bias.data_ptr(), None if sq is None else sq.data_ptr(),
            y.numel(), c, inner, int(y.dtype == torch.bfloat16), plan.vec, plan.blocks,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_bias_relu")
    launches += 1


def _launch_pool_root(p: torch.Tensor) -> None:
    global launches
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    _inner(p)  # dense: channels_last or NCHW
    plan = pool_root_plan(p.numel(), p.element_size(), p.data_ptr() % 16 == 0,
                          build.sm_count(p.device))
    with torch.cuda.device(p.device):
        code = lib.nqt_pool_root(p.data_ptr(), p.numel(), int(p.dtype == torch.bfloat16),
                                 plan.vec, plan.blocks, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "nqt_pool_root")
    launches += 1


class _BiasReLU(torch.autograd.Function):
    """The kernel in place; backward as ``relu_``'s (threshold_backward:
    no gradient where the output is ≤ 0, NaN outputs pass it)."""

    @staticmethod
    def forward(ctx, y, bias):
        _launch_bias_relu(y, bias, None)
        ctx.mark_dirty(y)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad.masked_fill(out <= 0, 0), None


class _PoolRoot(torch.autograd.Function):
    """The kernel in place; backward as ``sqrt_``'s, grad / (2·out)."""

    @staticmethod
    def forward(ctx, p):
        _launch_pool_root(p)
        ctx.mark_dirty(p)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad / (2 * out)


def bias_relu(y: torch.Tensor, bias: torch.Tensor, *, square: bool = False):
    """``relu(y + bias)`` over a (N, C, H, W) conv output, in place in
    ``y`` and in its dtype; returns ``h``, or ``(h, h²)`` with ``square``
    (the squares in a new tensor of ``y``'s layout). ``square`` is for
    passes that record no gradient: the caller that folds the squares in
    makes them itself under autograd."""
    _check(y, "bias_relu")
    if y.dim() != 4 or bias.shape != (y.shape[1],):
        raise ValueError(f"need a (N, C, H, W) map and C biases, got "
                         f"{tuple(y.shape)} and {tuple(bias.shape)}")
    if bias.requires_grad:
        raise RuntimeError("bias_relu: the bias requires grad; the VGG "
                           "backbone is frozen and the kernel gives it none")
    if square and _recording(y):
        raise RuntimeError("bias_relu: square=True under a recorded gradient")
    if y.device.type == "cpu" or y.numel() == 0:
        return bias_relu_plain(y, bias, square=square)
    b = bias.to(device=y.device, dtype=y.dtype).contiguous()
    if _recording(y):
        return _BiasReLU.apply(y, b)
    sq = torch.empty_like(y) if square else None
    _launch_bias_relu(y, b, sq)
    return (y, sq) if square else y


def pool_root(p: torch.Tensor) -> torch.Tensor:
    """``sqrt(p + 1e-12)`` in place over the L2 pool's conv output."""
    _check(p, "pool_root")
    if p.device.type == "cpu" or p.numel() == 0:
        return pool_root_plain(p)
    if _recording(p):
        return _PoolRoot.apply(p)
    _launch_pool_root(p)
    return p
