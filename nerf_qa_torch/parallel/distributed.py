"""Multi-process setup and per-process input sharding.

Counterpart of ``nerf_qa_tpu/parallel/distributed.py``. The reference is
single-process (SURVEY §5.8). ``maybe_initialize`` forms a
``torch.distributed`` world from the cluster's environment variables, and
``HostShardedSampler`` gives each process its deterministic slice of a
sampler's index stream (``data.samplers.host_shard``), so each decodes
only its part. A trainer whose mesh carries the world's group sums its
gradients over the processes (``parallel.mesh.all_reduce_sum``).

The backend comes from the environment, never from a failed attempt: NCCL
when CUDA is present and each of this host's processes
(``LOCAL_WORLD_SIZE``, default 1) has a card of its own, gloo otherwise.
NCCL allows one rank per card, so two processes sharing one card take
gloo. Without a coordinator address nothing is initialised.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from nerf_qa_torch.data.samplers import host_shard


def default_backend() -> str:
    """'nccl' when every process of this host can have a CUDA device of
    its own, else 'gloo'."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Initialise ``torch.distributed`` when a cluster is configured.

    Uses the explicit arguments, else ``COORDINATOR_ADDRESS`` (or
    ``JAX_COORDINATOR_ADDRESS``, as the JAX package reads), ``NUM_PROCESSES``
    and ``PROCESS_ID``. The address is ``host:port`` or a URL
    (``tcp://host:port``). Under NCCL each process takes the card
    ``LOCAL_RANK`` (default: its rank modulo the card count). Returns True
    if distributed mode is active, False when no address is set."""
    addr = (coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
            or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if addr is None:
        return False
    if dist.is_initialized():
        return True
    world = num_processes or int(os.environ.get("NUM_PROCESSES", 0))
    if world < 1:
        raise ValueError("a coordinator address is set but NUM_PROCESSES is not: "
                         "torch.distributed needs the world size")
    rank = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", 0))
    backend = backend or default_backend()
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return True


def host_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) when not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class HostShardedSampler:
    """Wrap any index sampler so each process sees only its deterministic
    slice (the same permutation in every process, ``host_shard`` slicing)."""

    def __init__(self, sampler, host_id: int | None = None,
                 host_count: int | None = None):
        self.sampler = sampler
        hid, hcount = host_info()
        self.host_id = host_id if host_id is not None else hid
        self.host_count = host_count if host_count is not None else hcount

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        return iter(host_shard(list(self.sampler), self.host_id, self.host_count))

    def __len__(self) -> int:
        total = len(self.sampler)
        return (total - self.host_id + self.host_count - 1) // self.host_count
