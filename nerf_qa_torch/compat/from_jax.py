"""Weight bridge: the JAX package's parameters, as numpy, into the port's.

The JAX package keeps the VGG pyramid as a pytree ``{'stageK': [{'kernel':
HWIO, 'bias': (O,)}, ...]}`` (``init_vgg16_params``, or a converted
checkpoint) and α/β as flat (1475,) vectors. This module turns plain dicts
of ``np.ndarray`` into the port's reference-layout ``state_dict`` (the
layout ``nerf_qa_tpu/compat/export_torch._dists_module_out`` writes:
OIHW convs under torchvision indices, ``filter`` buffers, ImageNet
``mean`` / ``std``). It imports nothing of JAX: callers hand it numpy.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from nerf_qa_torch.core.dists import DISTSWeights
from nerf_qa_torch.core.vgg import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    STAGE_CONV_INDICES,
    STAGE_POOL_INDEX,
    VGG16_STAGES,
)
from nerf_qa_torch.ops.l2pool import hann_filter


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def reference_buffers() -> dict[str, torch.Tensor]:
    """The non-learned entries of the reference layout: the L2 pools'
    ``filter`` buffers and the ImageNet ``mean`` / ``std``."""
    sd = {}
    for si, idx in STAGE_POOL_INDEX.items():
        sd[f"stage{si}.{idx}.filter"] = hann_filter(VGG16_STAGES[si - 1][0][0])
    sd["mean"] = _t(IMAGENET_MEAN.reshape(1, 3, 1, 1))
    sd["std"] = _t(IMAGENET_STD.reshape(1, 3, 1, 1))
    return sd


def vgg_state_dict_from_jax(np_tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX pyramid params (HWIO kernels, numpy) -> the port's VGG16Pyramid
    ``state_dict`` (OIHW, reference key layout), loadable with
    ``strict=True``."""
    sd = {}
    for si, (spec, idxs) in enumerate(zip(VGG16_STAGES, STAGE_CONV_INDICES)):
        layers = np_tree[f"stage{si + 1}"]
        if len(layers) != len(spec):
            raise ValueError(f"stage{si + 1}: {len(layers)} layers, "
                             f"expected {len(spec)}")
        for layer, (cin, cout), idx in zip(layers, spec, idxs):
            k = np.asarray(layer["kernel"], np.float32)
            if k.shape != (3, 3, cin, cout):
                raise ValueError(f"stage{si + 1}.{idx}: kernel {k.shape}, "
                                 f"expected {(3, 3, cin, cout)}")
            sd[f"stage{si + 1}.{idx}.weight"] = _t(k.transpose(3, 2, 0, 1))
            sd[f"stage{si + 1}.{idx}.bias"] = _t(layer["bias"])
    sd.update(reference_buffers())
    return sd


def dists_weights_from_jax(alpha, beta) -> DISTSWeights:
    """JAX ``DISTSWeights`` fields (numpy, any shape of 1475 values) ->
    the port's DISTSWeights, unchanged (the variant transform was applied
    when the JAX side built them)."""
    return DISTSWeights(_t(np.asarray(alpha).reshape(-1)),
                        _t(np.asarray(beta).reshape(-1)))
