"""Index samplers (pure host-side numpy).

Counterpart of ``nerf_qa_tpu/data/samplers.py``, the part the NR trainer
uses: ``SceneBalancedSampler`` (data.py:407-427) — every epoch draws
min-scene-count indices per scene, shuffled — with an explicit numpy
Generator seeded by (seed, epoch), so the same seed gives the JAX
package's order.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Sequence

import numpy as np


class SceneBalancedSampler:
    """Equal per-scene sampling at the min scene count (data.py:407-427)."""

    def __init__(self, scene_indices: Mapping[str, Sequence[int]],
                 seed: int = 0):
        self.scene_indices = {k: np.asarray(v) for k, v in scene_indices.items()}
        self.samples_per_scene = min(len(v) for v in self.scene_indices.values())
        self.num_samples = self.samples_per_scene * len(self.scene_indices)
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng((self.seed, self.epoch))
        picked = []
        for indices in self.scene_indices.values():
            perm = rng.permutation(len(indices))[: self.samples_per_scene]
            picked.extend(indices[perm].tolist())
        picked = np.asarray(picked)
        yield from picked[rng.permutation(len(picked))].tolist()
