"""Profiling hooks: named spans that cost one flag check unless a profiler
records, and a trace on request.

Counterpart of ``nerf_qa_tpu/utils/profiling.py``. Reference behavior:
torch.profiler ``record_function("load_data") /
record_function("model_inference")`` scopes around the NR train loop
(train-nr.py:273,280; the enclosing profile() context is committed
disabled).

:func:`span` opens a ``torch.profiler.record_function`` range while a
profiler records, and returns a shared no-op context otherwise: it builds
no name and makes no range. Its integer arguments travel in the range's
name (``nr.cn:<rows>:<c>:<gelu>:<itemsize>``), so the counters lie on the
profiler's clock beside the device events. ``trace_if_enabled`` records
such a trace when asked, and does nothing otherwise;
``portbench/traces.py`` reads one.

The spans, outermost first (``:`` and the integers each carries):

* ``fr.score`` (``FrameScorer.score_batch``); inside it ``fr.h2d:<bytes>:
  <pageable>`` around the copy of a batch's frames to the device (bytes
  moved from host memory to a GPU, 0 when the frames are already there;
  pageable 1 when any of them comes from unpinned host memory), ``fr.prep``
  (``eval/video_scorer._prep``), ``dists.vgg`` (``VGG16Pyramid.forward``)
  and ``dists.stats:`` then n, h, w, c and itemsize of each stage of the
  first pyramid (``core/dists.pyramid_stats``);
* ``nr.forward`` (``NRModel.forward``) and ``nr.train_step``
  (``NRTrainer.train_step``); in a training step ``nr.encode``,
  ``nr.decoder_fwd``, ``nr.losses``, ``nr.score_map``, ``nr.backward`` and
  ``nr.optimizer``; inside those ``nr.vit`` (the ViT), ``nr.jbu:<n>:<h>:
  <w>:<c>:4`` (a JBU stage: the guidance's n, h, w, the source's channels),
  ``nr.decoder`` (``NRDecoder.forward``), ``nr.cn:<rows>:<c>:<gelu>:
  <itemsize>`` (a ChannelNorm) and, on autograd's thread, ``nr.cn_bwd`` with
  the same integers (the ChannelNorm backward kernel's call);
* ``adists.forward`` (``core/adists.forward``); inside it ``dists.vgg``,
  ``adists.weights`` (the entropy channel weights), and for each stage,
  coarse to fine, ``adists.norms`` (the inverse spatial L2 norms of both
  maps), ``adists.ps:<n>:<h>:<w>:<c>`` (γ and the cascade step: the stage's
  NHWC shape; inside it, where the γ kernel runs, ``adists.gamma:<n>:<h>:
  <w>:<c>:<itemsize>``) and either ``adists.tsd:<n>:<h>:<w>:<c>:<itemsize>`` (the
  windowed T/S map of a stage that fits the window) or ``adists.global``
  (a stage smaller than the window, with its ``adists.ps`` inside);
* ``ops.upload:<bytes>`` around each tensor a step builds on the host and
  places on its device, the build included (``ops/resize``'s matrices,
  the JBU's spatial Gaussian);
* ``fr.pyramid``, ``fr.stats``, ``fr.head_loss``, ``fr.backward``,
  ``fr.optimizer`` (FR training) and ``train_epoch`` (``run_fr``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterable, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["TRACE_ENV", "span", "trace_if_enabled"]

TRACE_ENV = "NERF_QA_TORCH_TRACE_DIR"

_OFF = contextlib.nullcontext()


def span(name: str, args: Callable[[], Iterable[int]] | None = None):
    """A profiler range named ``name``, followed by ``:a:b:...`` for the
    integers ``args()`` yields, while a profiler records; with none
    recording, a shared no-op context (``args`` is not called)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if args is not None:
        name = ":".join([name, *(str(int(v)) for v in args())])
    return record_function(name)


@contextlib.contextmanager
def trace_if_enabled(trace_dir: str | None = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (host ops and the spans
    above, and the device's kernels where CUDA is available), written to
    ``trace_dir`` or to ``$NERF_QA_TORCH_TRACE_DIR`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``; TensorBoard or
    chrome://tracing read it). Without either it does nothing."""
    trace_dir = trace_dir or os.environ.get(TRACE_ENV)
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(trace_dir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler):
        yield
