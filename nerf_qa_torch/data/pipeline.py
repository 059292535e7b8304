"""Batch assembly and the prefetching host->device feed.

Counterpart of ``nerf_qa_tpu/data/pipeline.py``. Reference behaviour:
torch DataLoader with 4-5 workers + pin_memory (data.py:180-188,281) and
recursive_collate for nested batch structures (data_fr.py:69-79). The
port's loader is ``torch.utils.data.DataLoader`` with
:func:`recursive_collate` (``data/factories.py``); its batches stay numpy.

:func:`device_prefetch` adds the H2D leg: each batch is copied into
pinned host memory and sent to the card with ``non_blocking=True`` on a
side stream, ``PREFETCH_BATCHES`` batches ahead of the consumer, so the
copy overlaps the previous step's compute. The compute stream waits on
the copy's event before it reads a batch, and each device tensor is
marked as used by the compute stream (``record_stream``) so the caching
allocator does not hand its memory to the side stream while a step still
reads it.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

# batches in flight on the side stream: double buffering
PREFETCH_BATCHES = 2


def _tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def device_prefetch(batches: Iterable,
                    device: str | torch.device = "cuda") -> Iterator:
    """Yield each batch (nested numpy arrays) as tensors on ``device``,
    keeping ``PREFETCH_BATCHES`` in flight ahead of the consumer. On a
    CUDA device the copies are pinned, non-blocking and on a side stream;
    on the CPU the arrays become tensors in place."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield _tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device),
                            batch)
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        host = _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                         .pin_memory(), batch)
        with torch.cuda.stream(side):
            dev = _tree_map(lambda t: t.to(device, non_blocking=True), host)
            ready = torch.cuda.Event()
            ready.record(side)
        return host, dev, ready

    it = iter(batches)
    buf: collections.deque = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= PREFETCH_BATCHES:
            break
    while buf:
        host, dev, ready = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        compute = torch.cuda.current_stream(device)
        compute.wait_event(ready)
        for t in _leaves(dev):
            t.record_stream(compute)
        yield dev
        del host  # pinned source kept alive until the consumer took the batch


def recursive_collate(items: Sequence[Any]):
    """Stack a list of samples into batched arrays, recursing through
    tuples/lists/dicts (data_fr.py:69-79)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: recursive_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            recursive_collate([it[i] for it in items]) for i in range(len(first))
        )
    if isinstance(first, np.ndarray):
        return np.stack(items)
    return np.asarray(items)
