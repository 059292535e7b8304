"""RefineUp decoder: predicts the ground-truth DISTS pyramid from the render's
DISTS pyramid and the semantic context, coarse to fine.

Counterpart of ``nerf_qa_tpu/models/nr/decoder.py``: one parameterised
module for the eight reference generations (SURVEY §2 #9-16).

* v7/v8 (model_nr_v7.py / model_nr_v8.py): the transformer context mixer
  with ``trans2sem`` and the ``refine_scale3`` / ``refine_scale4``
  residuals (decoder.py:286-314), then the ``RefineUp`` cascade with
  per-scale JBU semantic-pyramid injection, ChannelNorm+GELU blocks and
  ``refine_scale2`` residuals (decoder.py:73-127, 358-391).
* v1-v6 (model_nr.py .. model_nr_v6.py): the same mixer with BatchNorm
  (``trans2sem``), then the zero-seeded ``RefineUpLegacy`` cascade
  (front-slice integration of the render's features, BatchNorm+ReLU
  blocks, predictions as residuals off the render's own features;
  decoder.py:130-197, 393-437); v6 resamples at every stage and injects
  the bilinear-upsampled context (``align_corners=True``).
* v3 re-encodes the predictions through the frozen VGG stages with
  ``RefineDown`` (decoder.py:200-238, 439-473); v3 and v4 regress a score
  residual from the 16² mix, v5 / v6 from the full-resolution map, with
  ``ScoreRegHead`` (decoder.py:241-260); v4 has no cascade at all.

Key layout: the reference's trained-decoder ``state_dict``
(``transformer_decoder.{i}.*``, ``trans2sem.*``,
``decoder.{i}.block.{j}.*``, ``decoder.{i}.upsample_layer.*``), so a v7/v8
train-nr.py checkpoint loads with ``strict=True``. The v1-v6 modules
extend it (``refine_down.{k}.*``, ``score_reg.block.{j}.*``, BatchNorm
buffers under ``norm_layer``); no reference v1-v6 checkpoint is read
(``compat/pretrained.load_nr_torch_file`` refuses one).

Public tensors are NHWC as in the JAX package; inside, maps are NCHW in
channels_last memory.

``decoder_dtype='bfloat16'`` computes the transformer mixer, ``trans2sem``
and the RefineUp convs in bf16 with fp32 master weights, as
decoder.py:281-309, 382 do: the mixer's residual stream and
``trans_decode`` stay fp32, each RefineUp stage casts its blended input to
bf16, and the predicted features come out in bf16. The v1-v6 cascade,
``RefineDown`` and ``ScoreRegHead`` compute in fp32 at any
``decoder_dtype``, as the JAX modules (which take no dtype) do. In
training mode the Dropout2d layers draw from the generator passed to
``forward``, and the BatchNorms normalise with the batch's statistics and
update their running averages.

``cfg.remat`` (v7/v8) checkpoints each RefineUp stage
(``torch.utils.checkpoint``, the JAX package's ``nn.remat(RefineUp)``,
decoder.py:365-368): its activations are recomputed in the backward. The
recomputation draws its dropout masks from a copy of the generator at the
state the stage started from, so it draws the masks the forward drew and
leaves the trainer's generator where a step without remat leaves it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nerf_qa_torch.config import NRModelConfig, torch_dtype
from nerf_qa_torch.core.vgg import IMAGENET_MEAN, IMAGENET_STD, VGG16Pyramid, vgg_stage_apply
from nerf_qa_torch.models.nr.layers import (
    ConvLayer,
    ConvTransposeLayer,
    TransformerBlock,
    generator_at,
    nchw,
    nhwc,
)
from nerf_qa_torch.ops.resize import resize_bilinear
from nerf_qa_torch.ops.subpixel import conv_transpose_2x

DISTS_CHNS: tuple[int, ...] = (3, 64, 128, 256, 512, 512)


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


def _front_add(x: torch.Tensor, y: torch.Tensor, chns: int) -> torch.Tensor:
    """``x[:, :chns] += y[..., :chns]`` as a new tensor (model_nr.py:76):
    NCHW ``x``, NHWC ``y``."""
    head = x[:, :chns] + nchw(y[..., :chns].float())
    return torch.cat([head, x[:, chns:]], dim=1).contiguous(
        memory_format=torch.channels_last)


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


class RefineUpLegacy(nn.Module):
    """v1-v6 refine stage (model_nr.py:33-88, model_nr_v6.py:50-95;
    decoder.py:130-197): front-slice integration of the render's feature,
    a BatchNorm+ReLU block, the prediction ``refine_scale2 ·
    block[:fc] + render_feat[:fc]`` (a residual off the render's own
    feature), then a raw 2x transposed conv.

    ``block_to_out`` (v1-v5) maps in -> out inside the block and resamples
    only when upsampling; v6 keeps the block at in -> in and always
    resamples (a transposed conv, or a conv layer). ``trans_inject`` (v6)
    adds the bilinear-upsampled (``align_corners=True``) context to the
    trailing semantic channels (model_nr_v6.py:80-83). fp32 throughout."""

    def __init__(self, input_chns: int, output_chns: int, feature_chns: int,
                 depth: int = 2, upsample: bool = True, block_to_out: bool = True,
                 always_resample: bool = False, trans_inject: bool = False,
                 dropout_rate: float = 0.0, refine_scale1: float = 1.0,
                 refine_scale2: float = 0.1):
        super().__init__()
        self.feature_chns = feature_chns
        self.trans_inject = trans_inject
        self.refine_scale1 = refine_scale1
        self.refine_scale2 = refine_scale2
        block_out = output_chns if block_to_out else input_chns
        outs = [input_chns] * (depth - 1) + [block_out]
        self.block = nn.ModuleList(
            ConvLayer(input_chns, o, activation=j < depth - 1,
                      dropout_rate=dropout_rate, norm_type="batch")
            for j, o in enumerate(outs))
        if upsample:
            # the reference's bare ConvTranspose2d(k3, s2, p1, outp1)
            self.upsample_layer = nn.ConvTranspose2d(block_out, output_chns, 3,
                                                     stride=2, padding=1,
                                                     output_padding=1)
        elif always_resample:
            self.upsample_layer = ConvLayer(block_out, output_chns, activation=False,
                                            dropout_rate=dropout_rate,
                                            norm_type="batch")
        else:
            self.upsample_layer = None

    def forward(self, input_feats: torch.Tensor, dists_feat: torch.Tensor,
                trans_decode: torch.Tensor, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """input_feats NCHW; dists_feat and trans_decode NHWC. Returns (the
        next stage's NCHW map, the NHWC fp32 predicted feature)."""
        fc = self.feature_chns
        x = _front_add(input_feats.float() * self.refine_scale1, dists_feat, fc)
        s = x.shape[1] - fc
        if self.trans_inject and s > 0:
            h, w = x.shape[2], x.shape[3]
            up = resize_bilinear(trans_decode[..., -s:].float(), h, w, align_corners=True)
            x = torch.cat([x[:, :fc], x[:, fc:] + nchw(up)], dim=1).contiguous(
                memory_format=torch.channels_last)
        h = x
        for layer in self.block:
            h = layer(h, generator)
        pred = self.refine_scale2 * nhwc(h[:, :fc]) + dists_feat[..., :fc].float()
        if isinstance(self.upsample_layer, nn.ConvTranspose2d):
            h = conv_transpose_2x(h, self.upsample_layer.weight, self.upsample_layer.bias)
        elif self.upsample_layer is not None:
            h = self.upsample_layer(h, generator)
        return h, pred


class RefineDown(nn.Module):
    """v3 re-encoding stage (model_nr_v3.py:65-93; decoder.py:200-238): the
    up-cascade's prediction at this level is added over the running map's
    leading shared channels, the map is optionally stride-2 downsampled
    (the reference's bare Conv2d, flax's SAME padding: one row and column
    at the bottom and right), conv-refined, and the re-encoded prediction
    is ``stage_out + refine_scale · block[:oc]``, where ``stage_out`` is
    the frozen VGG stage of the map's leading channels (the caller's).
    fp32 throughout."""

    def __init__(self, input_chns: int, output_chns: int, depth: int = 2,
                 downsample: bool = True, dropout_rate: float = 0.0,
                 refine_scale: float = 0.1):
        super().__init__()
        self.refine_scale = refine_scale
        self.downsample_layer = (nn.Conv2d(input_chns, input_chns, 3, stride=2)
                                 if downsample else None)
        outs = [input_chns] * (depth - 1) + [output_chns]
        self.block = nn.ModuleList(
            ConvLayer(input_chns, o, activation=j < depth - 1,
                      dropout_rate=dropout_rate, norm_type="batch")
            for j, o in enumerate(outs))

    def forward(self, input_feats: torch.Tensor, additional_feats: torch.Tensor,
                stage_out: torch.Tensor, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """input_feats NCHW; additional_feats and stage_out NHWC. Returns
        (the next NCHW map, the NHWC fp32 re-encoded prediction)."""
        shared = min(input_feats.shape[1], additional_feats.shape[-1])
        x = _front_add(input_feats.float(), additional_feats, shared)
        if self.downsample_layer is not None:
            x = F.conv2d(F.pad(x, (0, 1, 0, 1)), self.downsample_layer.weight,
                         self.downsample_layer.bias, stride=2)
        h = x
        for layer in self.block:
            h = layer(h, generator)
        oc = stage_out.shape[-1]
        return h, self.refine_scale * nhwc(h[:, :oc]) + stage_out.float()


class ScoreRegHead(nn.Module):
    """Auxiliary score-regression head (decoder.py:241-260): two conv
    layers, the second without activation, giving the raw (N, H, W, k)
    map that the model pools and calibrates. v3/v4 (model_nr_v3.py:229-232)
    and the v7/v8 extension read the 16² mix, v5/v6
    (model_nr_v6.py:167-170) the full-resolution map. fp32, BatchNorm for
    v1-v6 and ChannelNorm for v7/v8 (``norm_type``)."""

    def __init__(self, input_chns: int, channels: int, hidden: int,
                 dropout_rate: float = 0.0, norm_type: str = "batch"):
        super().__init__()
        self.block = nn.ModuleList([
            ConvLayer(input_chns, hidden, activation=True, dropout_rate=dropout_rate,
                      norm_type=norm_type),
            ConvLayer(hidden, channels, activation=False, dropout_rate=dropout_rate,
                      norm_type=norm_type)])

    def forward(self, mixed: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NCHW in, NHWC fp32 out."""
        h = mixed
        for layer in self.block:
            h = layer(h, generator)
        return nhwc(h).float()


class NRDecoder(nn.Module):
    """Transformer context mixer + the version's cascade
    (model_nr_v8.py:190-236 and the per-version variants above).

    The v7/v8 cascade's last resampled map is read only by the v5/v6
    score-regression head, so the v7/v8 cascade does not compute it:
    ``decoder.5.upsample_layer`` never runs, as in the JAX package's jit
    lowering, and keeps its weights so that reference checkpoints load
    with ``strict=True``.

    ``qkv_bias`` and ``layer_scale`` default to the reference decoder's
    blocks (no qkv bias, Identity LayerScale); a checkpoint that carries
    them (the JAX package's export of a decoder it trained) is built with
    them on (``from_state_dict``)."""

    def __init__(self, cfg: NRModelConfig = NRModelConfig(), sem_dim: int = 384,
                 dists_chns: Sequence[int] = DISTS_CHNS, qkv_bias: bool = False,
                 layer_scale: bool = False):
        super().__init__()
        if cfg.version not in range(1, 9):
            raise ValueError(f"NR version {cfg.version}: 1-8")
        if cfg.decoder_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"decoder_dtype={cfg.decoder_dtype!r}: 'float32' "
                             "or 'bfloat16'")
        if cfg.remat and cfg.version < 7:
            raise ValueError("remat checkpoints the v7/v8 RefineUp stages; "
                             f"v{cfg.version} has none")
        self.cfg = cfg
        v = cfg.version
        dtype = torch_dtype(cfg.decoder_dtype)
        self.sem_dim = sem_dim
        self.dists_chns = tuple(dists_chns)
        d_chns, s_chns = version_schedules(v, sem_dim)
        top_dim = self.dists_chns[-1]
        mix_dim = top_dim + sem_dim
        reg = cfg.reg_channels
        self.transformer_decoder = nn.ModuleList(
            TransformerBlock(mix_dim, 8, layer_scale_init=1.0 if layer_scale else None,
                             qkv_bias=qkv_bias, dtype=dtype)
            for _ in range(cfg.transformer_decoder_depth))
        if cfg.transformer_decoder_depth > 0:
            self.trans2sem = ConvLayer(mix_dim, sem_dim, activation=True,
                                       dropout_rate=cfg.dropout_rate, dtype=dtype,
                                       norm_type=cfg.norm_type)
        self.score_reg = None
        if v == 4:
            self.score_reg = ScoreRegHead(mix_dim, max(reg, 1), sem_dim,
                                          cfg.dropout_rate, "batch")
            return
        if reg > 0 and (v == 3 or v >= 7):
            self.score_reg = ScoreRegHead(mix_dim, reg, sem_dim, cfg.dropout_rate,
                                          cfg.norm_type)
        self.decoder = nn.ModuleList()
        if v >= 7:
            rev = list(reversed(self.dists_chns))  # [512, 512, 256, 128, 64, 3]
            num_upscales = len(rev) - 2
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
            return
        in_ch = mix_dim
        num_upscales = len(d_chns) - (3 if v <= 5 else 2)
        for i in range(num_upscales + 2):
            if v <= 5:
                fc, out_ch = d_chns[i + 1], d_chns[i + 1] + s_chns[i + 1]
            else:
                fc = d_chns[i]
                last = i >= len(d_chns) - 1
                out_ch = (d_chns[i] + s_chns[i] if last
                          else d_chns[i + 1] + s_chns[i + 1])
            self.decoder.append(RefineUpLegacy(
                input_chns=in_ch, output_chns=out_ch, feature_chns=fc,
                depth=cfg.refine_up_depth, upsample=i < num_upscales,
                block_to_out=v <= 5, always_resample=v == 6, trans_inject=v == 6,
                dropout_rate=cfg.dropout_rate, refine_scale1=cfg.refine_scale1,
                refine_scale2=cfg.refine_scale2))
            in_ch = out_ch
        if v == 3:
            self.refine_down = nn.ModuleList()
            for k in range(5):
                ref_i = 5 - k
                out_ch = d_chns[ref_i] + s_chns[ref_i]
                self.refine_down.append(RefineDown(
                    in_ch, out_ch, depth=cfg.refine_up_depth,
                    downsample=ref_i <= len(d_chns) - 3,
                    dropout_rate=cfg.dropout_rate, refine_scale=cfg.refine_scale2))
                in_ch = out_ch
        if reg > 0 and v in (5, 6):
            last_chns = d_chns[-1] + s_chns[-1]
            self.score_reg = ScoreRegHead(last_chns, reg, last_chns, cfg.dropout_rate,
                                          "batch")

    @classmethod
    def from_state_dict(cls, state_dict, cfg: NRModelConfig = NRModelConfig(),
                        sem_dim: int = 384) -> "NRDecoder":
        """A decoder built to match a reference-layout ``state_dict`` (qkv
        bias and LayerScale when it holds them), loaded with
        ``strict=True``; a depth or version that disagrees with ``cfg``
        raises."""
        model = cls(cfg, sem_dim,
                    qkv_bias="transformer_decoder.0.attn.qkv.bias" in state_dict,
                    layer_scale="transformer_decoder.0.ls1.gamma" in state_dict)
        model.load_state_dict(state_dict, strict=True)
        return model

    def _mixer(self, top: torch.Tensor, sem_feats: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """The transformer context mixer: ``trans_decode`` (N, gh, gw, D),
        fp32 (the raw semantic map without a mixer)."""
        cfg = self.cfg
        n, gh, gw, _ = top.shape
        trans_decode = sem_feats.float()
        if cfg.transformer_decoder_depth == 0:
            return trans_decode
        encoder_feats = torch.cat([top, trans_decode], dim=-1)
        tokens = encoder_feats.reshape(n, gh * gw, -1)
        for blk in self.transformer_decoder:
            tokens = blk(tokens)
        mixed = self.trans2sem(nchw(
            encoder_feats + cfg.refine_scale3 * tokens.reshape(n, gh, gw, -1)),
            generator)
        return trans_decode + cfg.refine_scale4 * nhwc(mixed).float()

    def _stage(self, i: int, feature_map, dists_feat, sem_feat, generator, resample):
        """RefineUp stage ``i``, checkpointed under ``cfg.remat`` when autograd
        records: the recomputation replays the dropout masks from a copy of
        ``generator`` at the stage's starting state."""
        stage = self.decoder[i]
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return stage(feature_map, dists_feat, sem_feat, generator, resample)
        start = None if generator is None else generator.get_state()
        calls = []

        def run(fm, df, sf):
            g = generator
            if calls and generator is not None:  # the backward's recomputation
                g = generator_at(generator, start)
            calls.append(1)
            return stage(fm, df, sf, g, resample)

        return checkpoint(run, feature_map, dists_feat, sem_feat, use_reentrant=False,
                          preserve_rng_state=False)

    def forward(self, dists_feats: Sequence[torch.Tensor], sem_feats: torch.Tensor,
                sem_pyramid: Sequence[torch.Tensor],
                generator: torch.Generator | None = None,
                vgg: VGG16Pyramid | None = None):
        """dists_feats: the render's 6-level NHWC DISTS pyramid [x, s1..s5]
        (fp32 or bf16); sem_feats (N, gh, gw, D); sem_pyramid: the 6-level
        JBU pyramid (v7/v8; empty for v1-v6); generator: the dropout
        generator of a training step (None: no dropout); vgg: the frozen
        VGG pyramid (v3's RefineDown only). Returns (predicted GT DISTS
        features in [x, s1..s5] order as NHWC tensors, in the decoder's
        dtype for v7/v8 and fp32 for v1-v6, or None for v4; the (N, H, W, k)
        fp32 score-regression map, or None)."""
        cfg = self.cfg
        v = cfg.version
        top = dists_feats[-1].float()
        trans_decode = self._mixer(top, sem_feats, generator)
        score_reg = None
        if v == 4:
            return None, self.score_reg(nchw(torch.cat([top, trans_decode], dim=-1)),
                                        generator)
        if self.score_reg is not None and (v == 3 or v >= 7):
            mix = torch.cat([top, sem_feats.float() if v == 3 else trans_decode], dim=-1)
            score_reg = self.score_reg(nchw(mix), generator)
        n_levels = len(dists_feats)
        predicted = []
        if v >= 7:
            feature_map = nchw(torch.cat([top, trans_decode], dim=-1))
            last = len(self.decoder) - 1
            for i in range(len(self.decoder)):
                feature_map, pred = self._stage(i, feature_map,
                                                dists_feats[n_levels - 1 - i],
                                                sem_pyramid[i], generator, i < last)
                predicted.append(pred)
            return list(reversed(predicted)), score_reg
        seed_sem = torch.zeros_like(trans_decode) if v == 6 else trans_decode
        feature_map = nchw(torch.cat([torch.zeros_like(top), seed_sem], dim=-1))
        for i, stage in enumerate(self.decoder):
            feature_map, pred = stage(feature_map, dists_feats[n_levels - 1 - i],
                                      trans_decode, generator)
            predicted.append(pred)
        predicted = list(reversed(predicted))
        if v == 3:
            predicted = self._refine_down(feature_map, predicted, vgg, generator)
        if self.score_reg is not None and v in (5, 6):
            score_reg = self.score_reg(feature_map, generator)
        return predicted, score_reg

    def _refine_down(self, feature_map, predicted, vgg, generator):
        """v3's re-encoding cascade (model_nr_v3.py:256-267, 289-301;
        decoder.py:439-473): the predicted image, ImageNet-normalised, and
        the up-cascade's predictions re-encoded through the frozen VGG
        stages by the RefineDown layers."""
        if vgg is None:
            raise ValueError("NR v3 RefineDown needs the frozen VGG pyramid")
        d_chns, _ = version_schedules(3, self.sem_dim)
        mean = torch.as_tensor(IMAGENET_MEAN, device=predicted[0].device)
        std = torch.as_tensor(IMAGENET_STD, device=predicted[0].device)
        img = (predicted[0] - mean) / std
        additionals = [img] + predicted[1:]
        new_predicted = [img]
        fm = feature_map
        for k, layer in enumerate(self.refine_down):
            fc = d_chns[5 - k + 1]
            stage_out = vgg_stage_apply(vgg, k + 1, nhwc(fm[:, :fc]))
            fm, pred = layer(fm, additionals[k], stage_out, generator)
            new_predicted.append(pred)
        return new_predicted
