"""Weight bridge: the JAX package's parameters, as numpy, into the port's.

The JAX package keeps the VGG pyramid as a pytree ``{'stageK': [{'kernel':
HWIO, 'bias': (O,)}, ...]}`` (``init_vgg16_params``, or a converted
checkpoint), α/β as flat (1475,) vectors, and the NR ViT, JBU stack and
decoder as flax param trees. This module turns plain dicts of
``np.ndarray`` into the port's ``state_dict``s in the reference key
layouts: the DISTS module of ``nerf_qa_tpu/compat/export_torch.
_dists_module_out`` (OIHW convs under torchvision indices, ``filter``
buffers, ImageNet ``mean`` / ``std``), DINOv2's ViT keys, FeatUp's
upsampler keys and the reference NR decoder keys of
``export_nr_state_dict``. Each loads with ``strict=True``; the JAX
package's importers (``compat/torch_{vit,featup,nr}.py``) read them back.
The decoder mapping only moves, transposes and flips entries, so it maps
any pytree shaped like the decoder's params (a gradient, optax Adam's
``mu`` and ``nu``) as it maps the weights: ``nr_decoder_tensors_from_jax``
and ``adam_state_dict_from_jax``. It imports nothing of JAX: callers hand
it numpy.
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


def _conv1x1_or_kxk(layer: Mapping[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """flax Conv {'kernel': HWIO, 'bias'} -> torch (OIHW weight, bias)."""
    k = np.asarray(layer["kernel"], np.float32)
    return _t(k.transpose(3, 2, 0, 1)), _t(layer["bias"])


def _dense(layer: Mapping[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """flax Dense {'kernel': (in, out), 'bias'} -> torch Linear (out, in)."""
    return _t(np.asarray(layer["kernel"], np.float32).T), _t(layer["bias"])


def _block(sd: dict, prefix: str, blk: Mapping[str, Any], *,
           qkv_bias: bool | None, layer_scale: bool | None) -> None:
    """flax TransformerBlock -> DINOv2 Block keys. ``None`` for
    ``qkv_bias`` / ``layer_scale`` writes the entry only when it is not the
    reference's implicit default (zero bias, unit gamma), as
    ``compat/export_torch._block_out`` does; True always writes it."""
    sd[f"{prefix}.norm1.weight"] = _t(blk["LayerNorm_0"]["scale"])
    sd[f"{prefix}.norm1.bias"] = _t(blk["LayerNorm_0"]["bias"])
    attn = blk["Attention_0"]
    w, b = _dense(attn["Dense_0"])
    sd[f"{prefix}.attn.qkv.weight"] = w
    if qkv_bias or (qkv_bias is None and bool(b.any())):
        sd[f"{prefix}.attn.qkv.bias"] = b
    sd[f"{prefix}.attn.proj.weight"], sd[f"{prefix}.attn.proj.bias"] = _dense(
        attn["Dense_1"])
    for ls, ours in (("ls1", "LayerScale_0"), ("ls2", "LayerScale_1")):
        gamma = _t(blk[ours]["gamma"])
        if layer_scale or (layer_scale is None and not bool((gamma == 1).all())):
            sd[f"{prefix}.{ls}.gamma"] = gamma
    sd[f"{prefix}.norm2.weight"] = _t(blk["LayerNorm_1"]["scale"])
    sd[f"{prefix}.norm2.bias"] = _t(blk["LayerNorm_1"]["bias"])
    mlp = blk["Mlp_0"]
    sd[f"{prefix}.mlp.fc1.weight"], sd[f"{prefix}.mlp.fc1.bias"] = _dense(mlp["Dense_0"])
    sd[f"{prefix}.mlp.fc2.weight"], sd[f"{prefix}.mlp.fc2.bias"] = _dense(mlp["Dense_1"])


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``ViTS14`` params (numpy) -> the port's ViTS14 ``state_dict``
    (DINOv2 keys; ``pos_embed`` patch-only at the model grid)."""
    sd = {}
    sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"] = _conv1x1_or_kxk(
        params["patch_embed"])
    for name in ("cls_token", "register_tokens", "pos_embed"):
        sd[name] = _t(params[name])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        _block(sd, f"blocks.{i}", params[f"block{i}"], qkv_bias=True,
               layer_scale=True)
    sd["norm.weight"] = _t(params["norm"]["scale"])
    sd["norm.bias"] = _t(params["norm"]["bias"])
    return sd


def jbu_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``JBUStack`` params (numpy) -> the port's JBUStack
    ``state_dict`` in FeatUp's upsampler layout (the inverse of
    ``compat/torch_featup.convert_featup_jbu``)."""
    sd = {}
    for i in range(1, 5):
        u = params[f"up{i}"]
        sd[f"up{i}.range_temp"] = _t(np.asarray(u["range_temp"]).reshape(()))
        sd[f"up{i}.sigma_spatial"] = _t(np.asarray(u["sigma_spatial"]).reshape(()))
        for j, name in ((0, "range_proj_in"), (3, "range_proj_out")):
            (sd[f"up{i}.range_proj.{j}.weight"],
             sd[f"up{i}.range_proj.{j}.bias"]) = _conv1x1_or_kxk(u[name])
    sd["fixup_proj.1.weight"], sd["fixup_proj.1.bias"] = _conv1x1_or_kxk(
        params["fixup_proj"])
    return sd


def _conv_layer(sd: dict, prefix: str, layer: Mapping[str, Any]) -> None:
    """flax ConvLayer / ConvTransposeLayer -> reference ConvLayer keys. A
    transposed kernel (HWIO) becomes torch's (in, out, kh, kw) with the
    spatial flip undone (compat/torch_nr._conv_transpose inverted)."""
    if "ConvTranspose_0" in layer:
        k = np.asarray(layer["ConvTranspose_0"]["kernel"], np.float32)
        sd[f"{prefix}.conv.weight"] = _t(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        sd[f"{prefix}.conv.bias"] = _t(layer["ConvTranspose_0"]["bias"])
    else:
        sd[f"{prefix}.conv.weight"], sd[f"{prefix}.conv.bias"] = _conv1x1_or_kxk(
            layer["Conv_0"])
    sd[f"{prefix}.norm_layer.norm.weight"] = _t(layer["ChannelNorm_0"]["scale"])
    sd[f"{prefix}.norm_layer.norm.bias"] = _t(layer["ChannelNorm_0"]["bias"])


def nr_decoder_state_dict_from_jax(params: Mapping[str, Any],
                                   qkv_bias: bool | None = None,
                                   layer_scale: bool | None = None
                                   ) -> dict[str, torch.Tensor]:
    """JAX v7/v8 ``NRDecoder`` params (numpy) -> the reference decoder
    ``state_dict`` (``transformer_decoder.{i}``, ``trans2sem``,
    ``decoder.{i}.block.{j}``, ``decoder.{i}.upsample_layer``): the keys
    and values ``compat/export_torch.export_nr_state_dict`` writes.
    ``NRDecoder.from_state_dict`` loads it with ``strict=True``. By default
    the blocks' qkv bias and LayerScale are written when they differ from
    the reference's implicit zero bias and unit gamma; True writes them
    always, False never."""
    sd: dict[str, torch.Tensor] = {}
    n_trans = sum(1 for k in params if k.startswith("trans") and k != "trans2sem")
    for i in range(n_trans):
        _block(sd, f"transformer_decoder.{i}", params[f"trans{i}"],
               qkv_bias=qkv_bias, layer_scale=layer_scale)
    if "trans2sem" in params:
        _conv_layer(sd, "trans2sem", params["trans2sem"])
    n_refine = sum(1 for k in params if k.startswith("refine"))
    for i in range(n_refine):
        stage = params[f"refine{i}"]
        convs = sorted((k for k in stage if k.startswith("ConvLayer_")),
                       key=lambda k: int(k.split("_")[1]))
        if "ConvTransposeLayer_0" in stage:
            tail = stage["ConvTransposeLayer_0"]
        else:  # the non-upsampling stages end in a plain ConvLayer
            tail = stage[convs.pop()]
        for j, name in enumerate(convs):
            _conv_layer(sd, f"decoder.{i}.block.{j}", stage[name])
        _conv_layer(sd, f"decoder.{i}.upsample_layer", tail)
    return sd


def nr_decoder_tensors_from_jax(tree: Mapping[str, Any],
                                like: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A pytree shaped like the JAX decoder's params (a gradient, Adam's
    ``mu`` or ``nu``), numpy, -> tensors under the keys of the decoder
    ``state_dict`` ``like``, moved and flipped as the weights are."""
    return nr_decoder_state_dict_from_jax(
        tree, qkv_bias="transformer_decoder.0.attn.qkv.bias" in like,
        layer_scale="transformer_decoder.0.ls1.gamma" in like)


def adam_state_dict_from_jax(count, mu: Mapping[str, Any], nu: Mapping[str, Any],
                             decoder: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> dict:
    """optax Adam's state (``ScaleByAdamState``'s ``count``, ``mu``, ``nu``,
    numpy) -> a ``state_dict`` for ``optimizer``, a ``torch.optim.Adam``
    built over ``decoder.parameters()``: ``exp_avg`` = mu, ``exp_avg_sq`` =
    nu and ``step`` = count for each parameter, in the decoder's parameter
    order. Load it with ``optimizer.load_state_dict``."""
    like = decoder.state_dict()
    m = nr_decoder_tensors_from_jax(mu, like)
    v = nr_decoder_tensors_from_jax(nu, like)
    names = [name for name, _ in decoder.named_parameters()]
    if set(names) != set(m):
        raise ValueError(f"Adam state keys {sorted(set(m) ^ set(names))} do not "
                         "match the decoder's parameters")
    state = {i: {"step": torch.tensor(float(np.asarray(count))),
                 "exp_avg": m[name], "exp_avg_sq": v[name]}
             for i, name in enumerate(names)}
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
