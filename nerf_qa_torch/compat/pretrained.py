"""Pretrained-backbone resolution for the port's entry points.

Counterpart of ``nerf_qa_tpu/compat/pretrained.py``: the VGG16 pyramid,
the DISTS α/β, the DINOv2 ViT, the FeatUp JBU upsampler and the LPIPS /
ST-LPIPS ``lin`` weights, plus the reference-layout NR checkpoint.
Resolution order:

1. explicit CLI path (``--vgg-ckpt`` / ``--dists-weights`` /
   ``--vit-ckpt`` / ``--jbu-ckpt``);
2. environment variable (``NERF_QA_VGG_CKPT``, ``NERF_QA_DISTS_WEIGHTS``,
   ``NERF_QA_VIT_CKPT``, ``NERF_QA_JBU_CKPT``, ``NERF_QA_LPIPS_CKPT``,
   ``NERF_QA_STLPIPS_CKPT``);
3. bundled asset (α/β only — converted from the reference's weights.pt);
4. random weights with a loud warning (same FLOPs; quality numbers
   meaningless), from a seeded ``torch.Generator``; for the ``lin``
   weights, None with a warning (the metric then weighs channels 1/C).

The NR decoder and its α/β come from a reference-layout ``.pth`` or from a
port training checkpoint (``load_nr_torch_file``).

Formats: torch ``.pt`` / ``.pth`` / ``.bin`` load natively (a torchvision
VGG16, its ``features``, or a reference DISTS / FR / NR state dict), and
``.npz`` in the JAX package's format (``stageK.{i}.kernel`` HWIO and
``stageK.{i}.bias``, as ``compat/torch_weights.export_vgg16_to_npz``
writes).
"""
from __future__ import annotations

import math
import os
import re
import sys
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from nerf_qa_torch.compat import checkpoint
from nerf_qa_torch.compat.from_jax import reference_buffers, vgg_state_dict_from_jax
from nerf_qa_torch.config import DISTSConfig
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import (
    STAGE_CONV_INDICES,
    VGG16_STAGES,
    VGG16Pyramid,
    init_he_normal,
)
from nerf_qa_torch.models.nr.featup import JBUStack
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_

ENV_VGG = "NERF_QA_VGG_CKPT"
ENV_DISTS = "NERF_QA_DISTS_WEIGHTS"
ENV_VIT = "NERF_QA_VIT_CKPT"
ENV_JBU = "NERF_QA_JBU_CKPT"
ENV_LPIPS = "NERF_QA_LPIPS_CKPT"
ENV_STLPIPS = "NERF_QA_STLPIPS_CKPT"

# key prefixes of the trained decoder in a reference NR state_dict
NR_DECODER_PREFIXES = ("transformer_decoder.", "trans2sem.", "decoder.")

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
    g.add_argument("--vit-ckpt", default=None,
                   help="DINOv2 ViT-S/14-reg checkpoint (.pt/.pth); "
                        f"${ENV_VIT} fallback (NR drivers).")
    g.add_argument("--jbu-ckpt", default=None,
                   help="FeatUp JBU upsampler checkpoint (.pt/.pth); "
                        f"${ENV_JBU} fallback (NR v7/v8 drivers).")


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


def interpolate_pos_embed(patch_pos: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Resample a (1, M·M, D) patch position grid to (1, grid², D).

    Real ``dinov2_vits14_reg`` checkpoints carry a 37x37 grid (trained at
    518²); the NR model at 224² needs 16x16. DINOv2's own convention
    (``interpolate_pos_encoding``): bicubic, ``scale_factor = (grid +
    0.1) / M``, no antialias — the JAX package's
    ``compat/torch_vit.interpolate_pos_embed``."""
    n = patch_pos.shape[1]
    m = int(round(math.sqrt(n)))
    if m * m != n:
        raise ValueError(f"pos_embed patch count {n} is not a square grid")
    t = patch_pos.float()
    if m == grid_size:
        return t
    grid = t.reshape(1, m, m, -1).permute(0, 3, 1, 2)
    scale = float(grid_size + 0.1) / m
    out = F.interpolate(grid, scale_factor=(scale, scale), mode="bicubic",
                        antialias=False)
    if out.shape[-2:] != (grid_size, grid_size):
        raise ValueError(f"resampled grid {tuple(out.shape[-2:])}, expected "
                         f"{grid_size}x{grid_size}")
    return out.permute(0, 2, 3, 1).reshape(1, grid_size * grid_size, -1)


def vit_state_dict_from_dinov2(state_dict: Mapping[str, Any], depth: int = 12,
                               grid_size: int = 16) -> dict[str, torch.Tensor]:
    """A ``dinov2_vits14_reg`` state_dict (bare, under ``model`` /
    ``teacher``, or FeatUp's ``model.model.`` prefix) -> the port's
    ViTS14 ``state_dict``: the first ``depth`` blocks, the CLS row of
    ``pos_embed`` dropped and the grid resampled; ``mask_token`` and
    other training-only keys are left out."""
    for key in ("model", "teacher"):
        if isinstance(state_dict.get(key), Mapping):
            state_dict = state_dict[key]
    if any(k.startswith("model.model.") for k in state_dict):
        state_dict = {k[len("model.model."):]: v for k, v in state_dict.items()
                      if k.startswith("model.model.")}
    keep = ViTS14(depth=depth, grid_size=grid_size).state_dict().keys()
    sd = {}
    for k in keep:
        if k not in state_dict:
            raise KeyError(f"DINOv2 checkpoint has no {k}")
        sd[k] = torch.as_tensor(state_dict[k]).float()
    sd["pos_embed"] = interpolate_pos_embed(sd["pos_embed"][:, 1:], grid_size)
    return sd


def resolve_vit_params(path: str | None = None, depth: int = 12,
                       grid_size: int = 16, seed: int = 0) -> ViTS14:
    """DINOv2 ViT (on the CPU) from a checkpoint, or random with a
    warning."""
    path = path or os.environ.get(ENV_VIT)
    model = ViTS14(depth=depth, grid_size=grid_size)
    if path:
        model.load_state_dict(vit_state_dict_from_dinov2(
            _torch_load(path), depth, grid_size), strict=True)
        return model
    _warn("no DINOv2 checkpoint (--vit-ckpt / $" + ENV_VIT + ") — the NR "
          "semantic encoder uses RANDOM weights.")
    return init_vit_(model, torch.Generator().manual_seed(seed))


def jbu_state_dict_from_featup(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A FeatUp hub checkpoint (the full model under ``upsampler.``, the
    upsampler alone, or either under ``model`` / ``state_dict``) -> the
    port's JBUStack ``state_dict``."""
    for key in ("model", "state_dict"):
        if isinstance(state_dict.get(key), Mapping):
            state_dict = state_dict[key]
    if any(k.startswith("upsampler.") for k in state_dict):
        state_dict = {k[len("upsampler."):]: v for k, v in state_dict.items()
                      if k.startswith("upsampler.")}
    sd = {}
    for k, like in JBUStack(1).state_dict().items():
        if k not in state_dict:
            raise KeyError(f"FeatUp checkpoint has no upsampler key {k}")
        v = torch.as_tensor(state_dict[k]).float()
        # the scalar range_temp / sigma_spatial may be saved as (1,)
        sd[k] = v.reshape(()) if like.dim() == 0 else v
    return sd


def resolve_jbu_params(path: str | None = None, dim: int = 384,
                       seed: int = 1) -> JBUStack:
    """FeatUp JBU upsampler (on the CPU) from a checkpoint, or random with
    a warning."""
    path = path or os.environ.get(ENV_JBU)
    model = JBUStack(dim)
    if path:
        model.load_state_dict(jbu_state_dict_from_featup(_torch_load(path)),
                              strict=True)
        return model
    _warn("no FeatUp checkpoint (--jbu-ckpt / $" + ENV_JBU + ") — the JBU "
          "semantic pyramid uses RANDOM weights.")
    return init_lecun_normal_(model, torch.Generator().manual_seed(seed))


def lpips_lin_from_torch(state_dict: Mapping[str, Any]) -> list[torch.Tensor]:
    """An official LPIPS / ST-LPIPS vgg checkpoint -> its five per-channel
    ``lin`` weights, each (C_k,) fp32. The checkpoints store 1x1 convs of
    shape (1, C_k, 1, 1) under ``lin{k}.model.1.weight`` (or
    ``lins.{k}.model.1.weight``)."""
    out = []
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in state_dict:
                out.append(torch.as_tensor(state_dict[key]).detach().reshape(-1).float())
                break
        else:
            raise KeyError(f"lpips lin{k} weight not found")
    return out


def resolve_lpips_weights(path: str | None = None) -> list[torch.Tensor] | None:
    """LPIPS learned ``lin`` weights (``eval.iqa.lpips``); None -> the
    uniform 1/C fallback inside ``lpips()``, with a warning here."""
    path = path or os.environ.get(ENV_LPIPS)
    if path:
        return lpips_lin_from_torch(_torch_load(path))
    _warn("no LPIPS checkpoint (--lpips-ckpt / $" + ENV_LPIPS + ") — LPIPS "
          "uses uniform channel weights (uncalibrated).")
    return None


def resolve_stlpips_weights(path: str | None = None) -> list[torch.Tensor] | None:
    """ST-LPIPS learned ``lin`` weights (``eval.iqa.st_lpips``). The
    official ShiftTolerant-LPIPS vgg checkpoint stores its lin layers as
    LPIPS does; None -> the uniform 1/C fallback, with a warning here."""
    path = path or os.environ.get(ENV_STLPIPS)
    if path:
        return lpips_lin_from_torch(_torch_load(path))
    _warn("no ST-LPIPS checkpoint (--stlpips-ckpt / $" + ENV_STLPIPS + ") "
          "— ST-LPIPS uses uniform channel weights (uncalibrated).")
    return None


def _nr_checkpoint_file(path: str) -> str | None:
    """The ``state.pt`` of a port training checkpoint directory: ``path``
    itself (a ``step_<N>`` directory) or its latest step; None when
    ``path`` holds neither."""
    for d in (path, checkpoint.step_dir(path, checkpoint.latest_step(path) or 0)):
        f = os.path.join(d, checkpoint.STATE_FILE)
        if os.path.isfile(f):
            return f
    return None


_BATCHNORM_KEY = re.compile(r"\.(running_mean|running_var|num_batches_tracked)$")


def _as_float(v) -> torch.Tensor:
    t = torch.as_tensor(v)
    return t.float() if t.is_floating_point() else t


def load_nr_torch_file(path: str):
    """A reference-layout NR ``.pth`` (train-nr.py's saved v7/v8 state, or
    the JAX package's compat/export_torch.py ``--kind nr`` output), or a
    port training checkpoint (``tools/train_nr.py``'s ``ckpt`` directory,
    one of its ``step_<N>`` directories or their ``state.pt``; any
    version, BatchNorm buffers included) -> (decoder state_dict, DISTS α/β
    arrays or None). A JAX orbax checkpoint directory cannot be read
    without JAX and raises (ROADMAP, "Not to port"). A ``.pth`` with
    BatchNorm entries (a reference v1-v6 decoder) raises: neither package
    maps that layout (the JAX package's compat/torch_nr.py reads only the
    ChannelNorm one), and none of it is loaded."""
    if os.path.isdir(path):
        state_file = _nr_checkpoint_file(path)
        if state_file is None:
            raise ValueError(
                f"{path} is a directory without a port checkpoint (a JAX orbax "
                f"checkpoint?): {checkpoint.ORBAX_NOT_PORTED} The port reads "
                "reference-layout torch .pth files and its own training "
                "checkpoints; export a JAX one with the JAX package's "
                "nerf_qa_tpu/compat/export_torch.py --kind nr")
        path = state_file
    sd = _torch_load(path)
    if isinstance(sd, Mapping) and isinstance(sd.get("decoder"), Mapping):
        ab = sd.get("dists_alpha_beta")
        alpha_beta = None if ab is None else tuple(
            torch.as_tensor(ab[k]).reshape(-1).float().numpy() for k in ("alpha", "beta"))
        return {k: _as_float(v) for k, v in sd["decoder"].items()}, alpha_beta
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd).__name__}")
    sd = sd.get("state_dict", sd)
    decoder = {k: torch.as_tensor(v).float() for k, v in sd.items()
               if k.startswith(NR_DECODER_PREFIXES)}
    if not decoder:
        raise ValueError(f"{path}: no NR decoder keys ({', '.join(NR_DECODER_PREFIXES)})")
    batchnorm = sorted(k for k in sd if _BATCHNORM_KEY.search(k))
    if batchnorm:
        raise ValueError(
            f"{path}: BatchNorm entries ({batchnorm[0]}, ... {len(batchnorm)} in "
            "all): a reference-layout v1-v6 NR checkpoint, which neither package "
            "reads (the JAX package's compat/torch_nr.py maps only the v7/v8 "
            "ChannelNorm layout, norm_layer.norm.*). Nothing was loaded; train "
            "v1-v6 with the port (tools/train_nr.py --version) and score its "
            "checkpoint directory")
    alpha_beta = None
    for pre in ("encoder.dists.", "dists_model.", "dists."):
        if f"{pre}alpha" in sd:
            alpha_beta = tuple(torch.as_tensor(sd[f"{pre}{k}"]).detach().reshape(-1)
                               .float().numpy() for k in ("alpha", "beta"))
            break
    return decoder, alpha_beta
