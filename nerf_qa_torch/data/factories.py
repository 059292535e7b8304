"""Dataloader factory functions mirroring the reference's public API.

Counterpart of ``nerf_qa_tpu/data/factories.py``: create_test2_dataloader
(data.py:174-188), create_large_qa_dataloader (data.py:277-282),
create_nerf_qa_resize_dataloader (data.py:367-375), create_nr_dataloader
(the reference's NR loader) and create_test_video_dataloader
(data.py:395-405). Each builds a ``torch.utils.data.DataLoader`` with
worker processes and ``recursive_collate`` (batches of numpy arrays;
``data/pipeline.device_prefetch`` pins and copies them), in the order of
the scene-balanced sampler for the same seed as the JAX package's, or in
sequence with ``scene_balanced=False``.
"""
from __future__ import annotations

import os.path as path
from typing import Mapping, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, get_worker_info

from nerf_qa_torch.data.datasets import (
    LargeQADataset,
    NeRFQAResizedDataset,
    NerfNRQADataset,
    Test2Dataset,
)
from nerf_qa_torch.data.pipeline import recursive_collate
from nerf_qa_torch.data.samplers import SceneBalancedSampler
from nerf_qa_torch.data.video import load_video_frames
from nerf_qa_torch.settings import DEVICE_BATCH_SIZE_FR, DEVICE_BATCH_SIZE_NR


def _seed_worker(worker_id: int) -> None:
    """Give each worker process its own augmentation stream: the dataset's
    numpy Generator (a copy of the parent's) reseeded from the worker's
    torch seed, which differs per worker and per epoch."""
    info = get_worker_info()
    info.dataset.rng = np.random.default_rng(info.seed)


def _loader(dataset, batch_size: int, sampler, num_workers: int,
            seed: int) -> DataLoader:
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      num_workers=num_workers, collate_fn=recursive_collate,
                      worker_init_fn=_seed_worker,
                      generator=torch.Generator().manual_seed(seed))


def create_test2_dataloader(rows: Sequence[Mapping], dir: str,
                            batch_size: int = DEVICE_BATCH_SIZE_FR,
                            in_memory: bool = False, scene_balanced: bool = True,
                            num_workers: int = 4, seed: int = 0) -> DataLoader:
    dataset = Test2Dataset(dir=dir, rows=rows, in_memory=in_memory)
    sampler = (SceneBalancedSampler(dataset.get_scene_indices(), seed)
               if scene_balanced else None)
    return _loader(dataset, batch_size, sampler,
                   0 if in_memory else num_workers, seed)


def create_large_qa_dataloader(rows: Sequence[Mapping], dir: str, resize: bool = True,
                               batch_size: int = DEVICE_BATCH_SIZE_FR,
                               num_workers: int = 5, seed: int = 0) -> DataLoader:
    dataset = LargeQADataset(dir=dir, rows=rows, resize=resize)
    sampler = SceneBalancedSampler(dataset.get_scene_indices(), seed)
    return _loader(dataset, batch_size, sampler, num_workers, seed)


def create_nerf_qa_resize_dataloader(rows: Sequence[Mapping], dir: str,
                                     batch_size: int = DEVICE_BATCH_SIZE_FR,
                                     scene_balanced: bool = True,
                                     num_workers: int = 4,
                                     seed: int = 0) -> DataLoader:
    """With ``num_workers=0`` the augmentations draw from one Generator
    seeded with ``seed``, as the JAX loader's do; with workers, each
    worker reseeds it from the loader's ``seed``-seeded generator."""
    dataset = NeRFQAResizedDataset(dir=dir, rows=rows,
                                   rng=np.random.default_rng(seed))
    sampler = (SceneBalancedSampler(dataset.get_scene_indices(), seed)
               if scene_balanced else None)
    return _loader(dataset, batch_size, sampler, num_workers, seed)


def create_nr_dataloader(rows: Sequence[Mapping], dir: str, mode: str = "gt",
                         is_train: bool = False,
                         batch_size: int = DEVICE_BATCH_SIZE_NR,
                         num_workers: int = 4, seed: int = 0,
                         host_sharded: bool = False, **aug) -> DataLoader:
    """Batches in the sampler's order (the JAX package's for the same
    seed). With ``num_workers=0`` the augmentations draw from one
    Generator seeded with ``seed``, as the JAX loader's do; with workers,
    each worker reseeds it from the loader's ``seed``-seeded generator.
    ``host_sharded``: this process's slice of the order
    (``parallel.distributed.HostShardedSampler``)."""
    dataset = NerfNRQADataset(rows, dir=dir, mode=mode, is_train=is_train,
                              rng=np.random.default_rng(seed), **aug)
    sampler = SceneBalancedSampler(dataset.get_scene_indices(), seed)
    if host_sharded:
        from nerf_qa_torch.parallel.distributed import HostShardedSampler

        sampler = HostShardedSampler(sampler)
    return _loader(dataset, batch_size, sampler, num_workers, seed)


def create_test_video_dataloader(row: Mapping, dir: str, resize: bool = True,
                                 keep_aspect_ratio: bool = False,
                                 batch_size: int = DEVICE_BATCH_SIZE_FR):
    """Load both videos of one benchmark row and return (dist, ref) frame
    stacks (data.py:395-405); each is a frame directory or an mp4."""
    ref_path = path.join(dir, "Reference", row["reference_filename"])
    dist_path = path.join(dir, "NeRF-QA_videos", row["distorted_filename"])
    ref = load_video_frames(ref_path, resize=resize,
                            keep_aspect_ratio=keep_aspect_ratio)
    dist = load_video_frames(dist_path, resize=resize,
                             keep_aspect_ratio=keep_aspect_ratio)
    return dist, ref
