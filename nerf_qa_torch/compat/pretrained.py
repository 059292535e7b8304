"""Pretrained-backbone resolution for the port's entry points.

Counterpart of ``nerf_qa_tpu/compat/pretrained.py`` for this slice's two
backbones: the VGG16 pyramid and the DISTS α/β. Resolution order:

1. explicit CLI path (``--vgg-ckpt`` / ``--dists-weights``);
2. environment variable (``NERF_QA_VGG_CKPT``, ``NERF_QA_DISTS_WEIGHTS``);
3. bundled asset (α/β only — converted from the reference's weights.pt);
4. random VGG with a loud warning (same FLOPs; quality numbers
   meaningless), He-normal from a seeded ``torch.Generator``.

Formats: torch ``.pt`` / ``.pth`` / ``.bin`` load natively (a torchvision
VGG16, its ``features``, or a reference DISTS / FR / NR state dict), and
``.npz`` in the JAX package's format (``stageK.{i}.kernel`` HWIO and
``stageK.{i}.bias``, as ``compat/torch_weights.export_vgg16_to_npz``
writes).
"""
from __future__ import annotations

import os
import re
import sys
from typing import Any, Mapping

import numpy as np
import torch

from nerf_qa_torch.compat.from_jax import reference_buffers, vgg_state_dict_from_jax
from nerf_qa_torch.config import DISTSConfig
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import (
    STAGE_CONV_INDICES,
    VGG16_STAGES,
    VGG16Pyramid,
    init_he_normal,
)

ENV_VGG = "NERF_QA_VGG_CKPT"
ENV_DISTS = "NERF_QA_DISTS_WEIGHTS"

_REF_KEY = re.compile(r"stage[1-5]\.(\d+)\.(weight|bias)$")


def add_backbone_args(parser) -> None:
    """Attach the shared pretrained-backbone flags to an ArgumentParser."""
    g = parser.add_argument_group("pretrained backbones")
    g.add_argument("--vgg-ckpt", default=None,
                   help="torchvision VGG16 checkpoint (.pt/.pth) or "
                        f"converted .npz; ${ENV_VGG} fallback. Without it "
                        "the VGG pyramid is RANDOM (perf-identical, "
                        "quality-meaningless).")
    g.add_argument("--dists-weights", default=None,
                   help="DISTS α/β weights (.pt from the reference or "
                        f".npz); ${ENV_DISTS} fallback; defaults to the "
                        "bundled converted asset.")


def _warn(msg: str) -> None:
    print(f"WARNING: {msg}", file=sys.stderr)


def _is_torch(path: str) -> bool:
    return path.endswith((".pt", ".pth", ".bin"))


def _torch_load(path: str):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def vgg_state_dict_from_torch(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torchvision VGG16 (``features.{idx}.*`` or bare ``{idx}.*``) or a
    reference DISTS state dict (``stageK.{idx}.*``, bare or under
    ``encoder.dists.`` / ``dists_model.`` / ``dists.``) -> the port's
    VGG16Pyramid ``state_dict``."""
    by_idx: dict[str, Any] = {}
    for pre in ("encoder.dists.", "dists_model.", "dists.", ""):
        for k, v in state_dict.items():
            if k.startswith(pre):
                m = _REF_KEY.fullmatch(k[len(pre):])
                if m:
                    by_idx[f"{m.group(1)}.{m.group(2)}"] = v
        if by_idx:
            break
    if not by_idx:
        for k, v in state_dict.items():
            bare = k[len("features."):] if k.startswith("features.") else k
            by_idx[bare] = v
    sd = {}
    for si, (spec, idxs) in enumerate(zip(VGG16_STAGES, STAGE_CONV_INDICES)):
        for (cin, cout), idx in zip(spec, idxs):
            for leaf in ("weight", "bias"):
                if f"{idx}.{leaf}" not in by_idx:
                    raise KeyError(f"vgg16 features index {idx} ({leaf}) "
                                   "not found")
                t = torch.as_tensor(by_idx[f"{idx}.{leaf}"]).float()
                sd[f"stage{si + 1}.{idx}.{leaf}"] = t
            if sd[f"stage{si + 1}.{idx}.weight"].shape != (cout, cin, 3, 3):
                raise ValueError(f"features.{idx}: weight shape "
                                 f"{tuple(sd[f'stage{si + 1}.{idx}.weight'].shape)}")
    sd.update(reference_buffers())
    return sd


def load_vgg16_npz(path: str) -> dict[str, torch.Tensor]:
    """The JAX package's flat-key VGG ``.npz`` -> VGG16Pyramid state dict."""
    with np.load(path) as data:
        tree = {
            f"stage{si + 1}": [
                {"kernel": data[f"stage{si + 1}.{i}.kernel"],
                 "bias": data[f"stage{si + 1}.{i}.bias"]}
                for i in range(len(stage))
            ]
            for si, stage in enumerate(VGG16_STAGES)
        }
    return vgg_state_dict_from_jax(tree)


def resolve_vgg_params(path: str | None = None, seed: int = 0) -> VGG16Pyramid:
    """VGG16 pyramid (on the CPU) from a checkpoint, or random with a
    warning."""
    path = path or os.environ.get(ENV_VGG)
    model = VGG16Pyramid()
    if path:
        if _is_torch(path):
            sd = vgg_state_dict_from_torch(_torch_load(path))
        else:
            sd = load_vgg16_npz(path)
        model.load_state_dict(sd, strict=True)
        return model
    _warn(
        "no VGG16 checkpoint (--vgg-ckpt / $" + ENV_VGG + ") — using "
        "RANDOM pyramid weights; throughput is identical but quality "
        "scores are meaningless."
    )
    return init_he_normal(model, torch.Generator().manual_seed(seed))


def resolve_dists_weights(cfg: DISTSConfig = DISTSConfig(),
                          path: str | None = None) -> dists.DISTSWeights:
    """α/β perceptual weights: explicit path, env, or the bundled asset."""
    path = path or os.environ.get(ENV_DISTS)
    if path and _is_torch(path):
        raw = _torch_load(path)
        alpha, beta = (torch.as_tensor(raw[k]).detach().reshape(-1).numpy()
                       for k in ("alpha", "beta"))
        if alpha.shape != beta.shape or alpha.shape != (dists.TOTAL_CHANNELS,):
            raise ValueError(f"{path}: alpha/beta shapes {alpha.shape}, "
                             f"{beta.shape}; expected ({dists.TOTAL_CHANNELS},)")
        return dists.weights_from_arrays(alpha, beta, cfg)
    return dists.load_pretrained_weights(cfg, path)
