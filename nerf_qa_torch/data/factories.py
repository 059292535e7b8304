"""Dataloader factory for NR training.

Counterpart of ``nerf_qa_tpu/data/factories.py``, the part NR training
uses: ``create_nr_dataloader`` (the reference's NR loader: a
scene-balanced sampler over ``NerfNRQADataset``), on
``torch.utils.data.DataLoader`` with worker processes and
``recursive_collate`` (batches of numpy arrays; ``data/pipeline.
device_prefetch`` pins and copies them).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, get_worker_info

from nerf_qa_torch.data.datasets import NerfNRQADataset
from nerf_qa_torch.data.pipeline import recursive_collate
from nerf_qa_torch.data.samplers import SceneBalancedSampler

DEVICE_BATCH_SIZE_NR = 4  # the reference's settings.py DEVICE_BATCH_SIZE


def _seed_worker(worker_id: int) -> None:
    """Give each worker process its own augmentation stream: the dataset's
    numpy Generator (a copy of the parent's) reseeded from the worker's
    torch seed, which differs per worker and per epoch."""
    info = get_worker_info()
    info.dataset.rng = np.random.default_rng(info.seed)


def create_nr_dataloader(rows: Sequence[Mapping], dir: str, mode: str = "gt",
                         is_train: bool = False,
                         batch_size: int = DEVICE_BATCH_SIZE_NR,
                         num_workers: int = 4, seed: int = 0, **aug) -> DataLoader:
    """Batches in the sampler's order (the JAX package's for the same
    seed). With ``num_workers=0`` the augmentations draw from one
    Generator seeded with ``seed``, as the JAX loader's do; with workers,
    each worker reseeds it from the loader's ``seed``-seeded generator."""
    dataset = NerfNRQADataset(rows, dir=dir, mode=mode, is_train=is_train,
                              rng=np.random.default_rng(seed), **aug)
    sampler = SceneBalancedSampler(dataset.get_scene_indices(), seed)
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      num_workers=num_workers, collate_fn=recursive_collate,
                      worker_init_fn=_seed_worker,
                      generator=torch.Generator().manual_seed(seed))
