"""Device mesh: a (data, model) grid of torch devices and the split of a
batch over it.

Counterpart of ``nerf_qa_tpu/parallel/mesh.py``. The mesh is
single-controller, as JAX's is: one process drives every device of the
grid. The ``data`` axis splits the batch (each row of the grid scores or
trains on its shard); the ``model`` axis splits a frame's height in the
spatial mode (``parallel/spatial.py``). Devices may repeat: ``[cuda:0] *
4`` runs a four-way mesh on one card, and ``[cpu] * 8`` mirrors the JAX
tests' eight-device virtual mesh. A shard runs on its row's first device;
objects placed on the mesh get one copy per distinct device, shared where
devices repeat (:func:`replicate`).

A mesh may carry a ``torch.distributed`` process group: ``FRTrainer``
then sums its gradient over the group's processes as well (one
``all_reduce`` a step). Scoring never crosses processes.

:class:`ShardGroup` runs the shards of one data-parallel training step
as threads of this process; each gets a :class:`Shard`, which the model
takes in place of its dropout generator: the shard's dropout draws at
the global batch size, and the global batch statistics of a BatchNorm
(``models/nr/layers.BatchNorm``), where the shards meet.
"""
from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


def canonical_device(device) -> torch.device:
    """``torch.device(device)`` with a CUDA index filled in, so that
    ``cuda`` and ``cuda:0`` name one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process (the port's ``jax.devices()``);
    raises without CUDA, never falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh over the local devices needs "
                           "the GPU (pass devices=[...] to create_mesh for "
                           "others)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices, row-major, and an optional process
    group for FRTrainer's cross-process gradient sum."""

    devices: tuple[tuple[torch.device, ...], ...]
    group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> list[torch.device]:
        """The device each data shard runs on: its row's first."""
        return [row[0] for row in self.devices]

    @property
    def primary(self) -> torch.device:
        """Where a sharded result is gathered: the grid's first device."""
        return self.devices[0][0]

    @property
    def distinct_devices(self) -> list[torch.device]:
        """The grid's devices in order, each once."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def create_mesh(devices=None, model_parallel: int = 1, group=None) -> Mesh:
    """A ``(len(devices) // model_parallel, model_parallel)`` mesh over
    ``devices`` (default :func:`local_devices`). ``model_parallel`` must
    divide the device count; the data axis gets the rest."""
    devices = [canonical_device(d) for d in
               (devices if devices is not None else local_devices())]
    n = len(devices)
    if model_parallel < 1 or n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    rows = tuple(tuple(devices[i:i + model_parallel])
                 for i in range(0, n, model_parallel))
    return Mesh(rows, group)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_tail(a, pad: int):
    """``a`` (a tensor or numpy array) with its last row repeated ``pad``
    more times."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)])


def data_sharding(mesh: Mesh, n: int) -> list[slice]:
    """The data shards' rows of a leading axis of ``n``: equal contiguous
    slices, shard i on ``mesh.data_devices[i]`` (JAX's ``P('data')``
    layout). ``n`` must divide by the data axis."""
    k = mesh.shape[DATA_AXIS]
    if n % k:
        raise ValueError(f"a batch of {n} does not split over a data axis of "
                         f"{k}: pad it to {pad_to_multiple(n, k)}")
    step = n // k
    return [slice(i * step, (i + 1) * step) for i in range(k)]


def _map(tree, fn):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def to_device(tree, device: torch.device):
    """Tensors and numpy arrays of ``tree`` (tuples, lists, dicts) as
    tensors on ``device``; None stays None."""
    def move(a):
        if a is None:
            return None
        if not torch.is_tensor(a):
            a = np.asarray(a)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
        return a.to(device, non_blocking=True)
    return _map(tree, move)


def host_copy(tree, device: torch.device) -> tuple[int, int]:
    """(bytes that ``to_device(tree, device)`` copies from host memory to a
    GPU, 1 when any of them is unpinned host memory else 0). Reads the
    arrays' metadata only; nothing moves to a CPU ``device``."""
    moved = []

    def visit(a):
        if a is None or torch.device(device).type == "cpu":
            return
        if not torch.is_tensor(a):
            moved.append((np.asarray(a).nbytes, True))
        elif a.device.type == "cpu":
            moved.append((a.numel() * a.element_size(), not a.is_pinned()))
    _map(tree, visit)
    return sum(n for n, _ in moved), int(any(p for _, p in moved))


def shard_batch(mesh: Mesh, batch) -> list:
    """Split the leading axis of every array of ``batch`` (a tensor or
    numpy array, or a tuple / list / dict of them; None stays None) over
    the data axis: one batch per data shard, on its device."""
    sizes = []
    _map(batch, lambda a: a is None or sizes.append(len(a)))
    slices = data_sharding(mesh, sizes[0])
    return [to_device(_map(batch, lambda a, s=s: None if a is None else a[s]), d)
            for s, d in zip(slices, mesh.data_devices)]


def _module_device(module: nn.Module) -> torch.device | None:
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return None


def _copy_to(obj, device: torch.device):
    if isinstance(obj, nn.Module):
        if _module_device(obj) in (None, device):
            return obj
        return copy.deepcopy(obj).to(device)
    if hasattr(obj, "to") and not torch.is_tensor(obj):
        return obj.to(device)
    return to_device(obj, device)


def replicate(mesh: Mesh, obj) -> dict[torch.device, Any]:
    """One copy of ``obj`` (a module, a tensor, an object with ``.to``, or a
    tuple / list / dict of tensors) per distinct device of the mesh. A
    module already on a device is itself that device's copy; modules are
    deep-copied to the others."""
    return {d: _copy_to(obj, d) for d in mesh.distinct_devices}


class ShardGroup:
    """The shards of one data-parallel step as threads of this process.
    :meth:`run` starts one thread a shard; :meth:`sum` is where they meet:
    it waits for every shard and returns, on the caller's device, the sum
    of all shards' tensors in shard order, autograd included. Every shard
    gets the same bits. A failing shard breaks the barrier, so the others
    raise too instead of waiting."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots: list[torch.Tensor | None] = [None] * size

    def sum(self, index: int, t: torch.Tensor) -> torch.Tensor:
        self._slots[index] = t
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()  # no slot is overwritten before all have read
        total = parts[0].to(t.device)
        for p in parts[1:]:
            total = total + p.to(t.device)
        return total

    def run(self, fn: Callable[[int], Any]) -> list:
        """``fn(i)`` for every shard i, each in its own thread; the results
        in shard order. The first exception is raised here."""
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(i: int) -> None:
            try:
                results[i] = fn(i)
            except BaseException as e:  # re-raised by the caller below
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,), name=f"shard-{i}")
                   for i in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)), None)
        first = first or next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


class Shard:
    """Shard ``index`` of a :class:`ShardGroup` step over a global batch of
    ``total`` rows, of which it holds ``rows``. A sharded step passes it
    down the model in place of the dropout generator, so that the shards
    together compute the unsharded step: every dropout draw is made at the
    global batch's size from ``generator`` and the shard keeps its rows
    (:meth:`rand`), and BatchNorm statistics are the global batch's
    (:meth:`batch_stats`)."""

    def __init__(self, group: ShardGroup, index: int, rows: slice, total: int,
                 generator: torch.Generator):
        self.group = group
        self.index = index
        self.rows = rows
        self.total = total
        self.generator = generator

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def at(self, state: torch.Tensor) -> "Shard":
        """This shard with a new generator at ``state``: the replay of its
        draws."""
        g = torch.Generator(device=self.generator.device)
        g.set_state(state)
        return Shard(self.group, self.index, self.rows, self.total, g)

    def rand(self, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
        """The shard's rows of a uniform draw of shape ``(total,
        *shape[1:])``, drawn on the generator's device, on ``device``."""
        u = torch.rand((self.total, *shape[1:]), generator=self.generator,
                       device=self.generator.device)
        return u[self.rows].to(device)

    def batch_stats(self, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-channel mean and biased variance of an (N, C, H, W) fp32 map
        over the global batch: Σx and Σx² summed over the step's shards
        (equal shard sizes), with the gradient through the sum."""
        count = self.group.size * (xf.numel() // xf.shape[1])
        sums = self.group.sum(self.index, torch.stack([xf.sum(dim=(0, 2, 3)),
                                                       (xf * xf).sum(dim=(0, 2, 3))]))
        mean = sums[0] / count
        return mean, (sums[1] / count - mean.square()).clamp_min(0.0)


def all_reduce_sum(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Sum ``tensors`` over the processes of ``group`` with one
    ``all_reduce`` of their flat concatenation. Gloo reduces host memory,
    so under gloo the buffer is staged through the host; the choice is
    made by the group's backend."""
    import torch.distributed as dist

    device = tensors[0].device
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if dist.get_backend(group) == "gloo":
        flat = flat.cpu()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat.to(device)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out
