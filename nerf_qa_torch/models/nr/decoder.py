"""RefineUp decoder: predicts the ground-truth DISTS pyramid from the render's
DISTS pyramid and the semantic context, coarse to fine.

Counterpart of ``nerf_qa_tpu/models/nr/decoder.py``, v7/v8 path
(model_nr_v7.py / model_nr_v8.py): the transformer context mixer with
``trans2sem`` and the ``refine_scale3`` / ``refine_scale4`` residuals
(decoder.py:286-314), then the ``RefineUp`` cascade with per-scale JBU
semantic-pyramid injection and ``refine_scale2`` residual blocks
(decoder.py:73-127, 358-391). ``RefineUpLegacy``, ``RefineDown``,
``ScoreRegHead`` and v1-v6 are not yet ported (ROADMAP Queue 1 item 11):
constructing another version raises.

Key layout: the reference's trained-decoder ``state_dict``
(``transformer_decoder.{i}.*``, ``trans2sem.*``,
``decoder.{i}.block.{j}.*``, ``decoder.{i}.upsample_layer.*``), so a
train-nr.py checkpoint loads with ``strict=True``.

Public tensors are NHWC as in the JAX package; inside, maps are NCHW in
channels_last memory.

``decoder_dtype='bfloat16'`` computes the transformer mixer, ``trans2sem``
and the RefineUp convs in bf16 with fp32 master weights, as
decoder.py:281-309, 382 do: the mixer's residual stream and
``trans_decode`` stay fp32, each RefineUp stage casts its blended input to
bf16, and the predicted features come out in bf16. In training mode the
Dropout2d layers draw from the generator passed to ``forward``.
``cfg.remat`` (activation checkpointing) is not ported: it raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nerf_qa_torch.config import NRModelConfig, torch_dtype
from nerf_qa_torch.models.nr.layers import (
    ConvLayer,
    ConvTransposeLayer,
    TransformerBlock,
    nchw,
    nhwc,
)

DISTS_CHNS: tuple[int, ...] = (3, 64, 128, 256, 512, 512)

_V8_ONLY = ("NR v{v}: only the v7/v8 ChannelNorm generations are ported; "
            "v1-v6 (BatchNorm blocks, RefineUpLegacy, RefineDown, "
            "ScoreRegHead) wait for ROADMAP Queue 1 item 11")


def version_schedules(version: int, sem_dim: int) -> tuple[list, list]:
    """Per-generation (dists, sem) channel schedules (decoder.py:47-64)."""
    rev = list(reversed(DISTS_CHNS))  # [512, 512, 256, 128, 64, 3]
    if version >= 7:
        return rev, [sem_dim] * 6
    if version == 6:
        return rev, [sem_dim, sem_dim, sem_dim // 2, sem_dim // 4,
                     sem_dim // 8, sem_dim // 16]
    tail = sem_dim // 16 if version in (1, 5) else 0
    return [DISTS_CHNS[-1]] + rev, [
        sem_dim, sem_dim, sem_dim, sem_dim // 2, sem_dim // 4,
        sem_dim // 8, tail,
    ]


class RefineUp(nn.Module):
    """One refine(+upsample) stage, v7/v8 (model_nr_v8.py:53-104): blend
    the running map with [dists_feat, sem_feat], a conv block with a
    refine_scale2 residual, slice off the predicted DISTS channels, then
    resample (2x transposed conv, or a conv at the last two stages)."""

    def __init__(self, input_chns: int, output_chns: int, feature_chns: int,
                 depth: int = 2, upsample: bool = True, dropout_rate: float = 0.0,
                 refine_scale1: float = 1.0, refine_scale2: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_chns = feature_chns
        self.refine_scale1 = refine_scale1
        self.refine_scale2 = refine_scale2
        self.dtype = dtype
        # depth >= 2: GELU on every layer but the last; depth 1: no GELU
        acts = [True] * (depth - 1) + [False] if depth >= 2 else [False] * depth
        self.block = nn.Sequential(*(
            ConvLayer(input_chns, input_chns, activation=a,
                      dropout_rate=dropout_rate, dtype=dtype) for a in acts))
        tail = ConvTransposeLayer if upsample else ConvLayer
        self.upsample_layer = tail(input_chns, output_chns, activation=False,
                                   dropout_rate=dropout_rate, dtype=dtype)

    def forward(self, input_feats: torch.Tensor, dists_feat: torch.Tensor,
                sem_feat: torch.Tensor, generator: torch.Generator | None = None,
                resample: bool = True
                ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """input_feats NCHW (channels_last); dists_feat and sem_feat NHWC.
        Returns (the next stage's NCHW map, the predicted DISTS feature:
        an NHWC view of the pre-resample map's leading channels, in the
        stage's dtype). ``resample=False`` skips ``upsample_layer`` and
        returns ``(None, pred)``."""
        guide = torch.cat([dists_feat.float(), sem_feat.float()], dim=-1)
        x = (input_feats * self.refine_scale1 + nchw(guide)).to(self.dtype)
        h = x
        for layer in self.block:
            h = layer(h, generator)
        feature_map = self.refine_scale2 * h + x
        pred = nhwc(feature_map[:, : self.feature_chns])
        if not resample:
            return None, pred
        return self.upsample_layer(feature_map, generator), pred


class NRDecoder(nn.Module):
    """Transformer context mixer + RefineUp cascade (model_nr_v8.py:190-236),
    v7/v8.

    The last stage's resampled map is read only by the v5/v6
    score-regression head (decoder.py:347-353, ROADMAP Queue 1 item 11),
    so the v7/v8 cascade does not compute it: ``decoder.5.upsample_layer``
    never runs, as in the JAX package's jit lowering, and keeps its
    weights so that reference checkpoints load with ``strict=True``.

    ``qkv_bias`` and ``layer_scale`` default to the reference decoder's
    blocks (no qkv bias, Identity LayerScale); a checkpoint that carries
    them (the JAX package's export of a decoder it trained) is built with
    them on (``from_state_dict``)."""

    def __init__(self, cfg: NRModelConfig = NRModelConfig(), sem_dim: int = 384,
                 dists_chns: Sequence[int] = DISTS_CHNS, qkv_bias: bool = False,
                 layer_scale: bool = False):
        super().__init__()
        if cfg.version not in (7, 8):
            raise NotImplementedError(_V8_ONLY.format(v=cfg.version))
        if cfg.reg_channels:
            raise NotImplementedError(
                "the score-regression head (ScoreRegHead) is not yet ported "
                "(ROADMAP Queue 1 item 11)")
        if cfg.remat:
            raise NotImplementedError(
                "remat=True (activation checkpointing of the RefineUp stages) "
                "is not ported: torch.utils.checkpoint restores only the "
                "global RNGs, so the explicit-generator dropout would draw a "
                "new mask on recompute (ROADMAP Queue 1 item 11)")
        if cfg.decoder_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"decoder_dtype={cfg.decoder_dtype!r}: 'float32' "
                             "or 'bfloat16'")
        self.cfg = cfg
        dtype = torch_dtype(cfg.decoder_dtype)
        self.sem_dim = sem_dim
        self.dists_chns = tuple(dists_chns)
        mix_dim = self.dists_chns[-1] + sem_dim
        self.transformer_decoder = nn.ModuleList(
            TransformerBlock(mix_dim, 8, layer_scale_init=1.0 if layer_scale else None,
                             qkv_bias=qkv_bias, dtype=dtype)
            for _ in range(cfg.transformer_decoder_depth))
        if cfg.transformer_decoder_depth > 0:
            self.trans2sem = ConvLayer(mix_dim, sem_dim, activation=True,
                                       dropout_rate=cfg.dropout_rate, dtype=dtype)
        rev = list(reversed(self.dists_chns))  # [512, 512, 256, 128, 64, 3]
        num_upscales = len(rev) - 2
        self.decoder = nn.ModuleList()
        for i in range(num_upscales + 2):
            out_dists = rev[i + 1] if i < len(rev) - 1 else rev[i]
            self.decoder.append(RefineUp(
                input_chns=rev[i] + sem_dim,
                output_chns=out_dists + sem_dim,
                feature_chns=rev[i],
                depth=cfg.refine_up_depth,
                upsample=i < num_upscales,
                dropout_rate=cfg.dropout_rate,
                refine_scale1=cfg.refine_scale1,
                refine_scale2=cfg.refine_scale2,
                dtype=dtype,
            ))

    @classmethod
    def from_state_dict(cls, state_dict, cfg: NRModelConfig = NRModelConfig(),
                        sem_dim: int = 384) -> "NRDecoder":
        """A decoder built to match a reference-layout ``state_dict`` (qkv
        bias and LayerScale when it holds them), loaded with
        ``strict=True``; a depth that disagrees with ``cfg`` raises."""
        model = cls(cfg, sem_dim,
                    qkv_bias="transformer_decoder.0.attn.qkv.bias" in state_dict,
                    layer_scale="transformer_decoder.0.ls1.gamma" in state_dict)
        model.load_state_dict(state_dict, strict=True)
        return model

    def forward(self, dists_feats: Sequence[torch.Tensor], sem_feats: torch.Tensor,
                sem_pyramid: Sequence[torch.Tensor],
                generator: torch.Generator | None = None):
        """dists_feats: the render's 6-level NHWC DISTS pyramid [x, s1..s5]
        (fp32 or bf16); sem_feats (N, gh, gw, D); sem_pyramid: the 6-level
        JBU pyramid; generator: the dropout generator of a training step
        (None: no dropout). Returns (predicted GT DISTS features in
        [x, s1..s5] order as NHWC views in the decoder's dtype, None) — the
        second slot is the score-regression map of the generations that
        have one."""
        cfg = self.cfg
        top = dists_feats[-1].float()
        n, gh, gw, _ = top.shape
        trans_decode = sem_feats.float()
        if cfg.transformer_decoder_depth > 0:
            encoder_feats = torch.cat([top, trans_decode], dim=-1)
            tokens = encoder_feats.reshape(n, gh * gw, -1)
            for blk in self.transformer_decoder:
                tokens = blk(tokens)
            mixed = self.trans2sem(nchw(
                encoder_feats + cfg.refine_scale3 * tokens.reshape(n, gh, gw, -1)),
                generator)
            trans_decode = trans_decode + cfg.refine_scale4 * nhwc(mixed).float()
        feature_map = nchw(torch.cat([top, trans_decode], dim=-1))
        predicted = []
        last = len(self.decoder) - 1
        for i, stage in enumerate(self.decoder):
            feature_map, pred = stage(feature_map, dists_feats[len(dists_feats) - 1 - i],
                                      sem_pyramid[i], generator, resample=i < last)
            predicted.append(pred)
        return list(reversed(predicted)), None
