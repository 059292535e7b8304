"""No-reference quality model (flagship: v8; v1-v7 as config points):
serving and training.

Counterpart of ``nerf_qa_tpu/models/nr/model.py``. Reference behaviour:
model_nr_v8.py:138-274 —

* encoder (frozen): the ViT (+ the JBU semantic pyramid for v7/v8) on the
  224² render, the DISTS VGG pyramid on the 256² render (:156-166); cached
  ViT tokens (``sem_tokens``, ``data/feature_cache.py``) skip the ViT and
  the JBU still runs;
* decoder: the transformer context mixer + the version's cascade
  predicting the ground-truth DISTS pyramid (:217-236), and the v3-v6
  score-regression heads;
* score: DISTS of the render's features against the predicted ones
  (:239-246), through ``core/dists.score_from_feats`` (the CUDA moments
  kernel under ``stats_impl='kernel'``), plus ``score_reg_scale`` times
  the regressed residual (v3/v5/v6; v4 is the regression alone);
* losses (:250-274, the ``gt`` objective of train-nr.py): ``l1`` between
  the predicted score and the ground-truth DISTS score (self-supervised),
  ``dists_pref2ref`` = DISTS(predicted features, GT features), combined by
  ``dists_pref2ref_coeff``; the v5/v6 MAE map and v6 std / mean
  calibration terms (model_nr_v5.py:235-250, model_nr_v6.py:245-276); the
  optional ``re_encode`` term; and the score-map objective
  (``score_map=``, mode 'score-map'): the ADISTS map of the clipped
  predicted image against the render, in ``-log10``, as an L1 against the
  prep's map (nerf_nr_qa_prep_4.py:101-135).

The encoder runs under ``torch.no_grad()`` with frozen weights. The
decoder is the only trainable part: on the card its ChannelNorms (v7/v8)
launch the forward kernel and, under autograd, the backward kernel. The
v1-v6 decoders keep their BatchNorm running averages as buffers: they
update in training mode (``decoder.train()``) and normalise in eval mode,
as the JAX package's ``batch_stats`` do with and without a dropout key.
The score-map loss differentiates ADISTS through the predicted image, so
its T/S map takes the plain version (the kernel has no backward).

Precision: with ``cfg.dists.compute_dtype='float32'`` the serving forward
runs in true fp32 (no TF32), the parity path; with 'bfloat16' the VGG
pyramid runs in bf16 and the rest at PyTorch's defaults on the card
(cuDNN convolutions in TF32, matmuls in fp32). The decoder computes in
``cfg.decoder_dtype`` (layers.py's explicit casts); a training step runs
in ``train_precision()``, true fp32 unless both the VGG and the decoder
are bf16.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn
from torch.profiler import record_function

from nerf_qa_torch.config import ADISTSConfig, NRModelConfig, torch_dtype, true_fp32
from nerf_qa_torch.core import adists, dists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.featup import JBUStack
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_
from nerf_qa_torch.ops.resize import resize_bilinear


class EncoderFeats(NamedTuple):
    dists_feats: list  # 6-level render DISTS pyramid [x, s1..s5], NHWC
    sem_feats: torch.Tensor  # (N, 16, 16, D) low-res semantic map
    sem_pyramid: list  # 6-level JBU semantic pyramid, NHWC fp32 (v7/v8)


class NRModel(nn.Module):
    """The frozen encoder (VGG pyramid, ViT, and the JBU stack for v7/v8),
    the decoder and the DISTS α/β in one module. Missing parts are random
    from ``seed`` (seeded ``torch.Generator``s); ``render_size / 16`` must
    equal ``sem_size / 14`` so the DISTS stage-5 grid matches the ViT
    grid. ``jbu`` is ignored for v1-v6, which have no JBU pyramid."""

    def __init__(self, vgg: VGG16Pyramid,
                 dists_weights: dists.DISTSWeights | None = None,
                 cfg: NRModelConfig = NRModelConfig(),
                 vit: ViTS14 | None = None, jbu: JBUStack | None = None,
                 decoder: NRDecoder | None = None, seed: int = 0,
                 render_size: int = 256, sem_size: int = 224):
        super().__init__()
        if render_size // 16 != sem_size // 14:
            raise ValueError(f"render {render_size} / 16 != sem {sem_size} / 14")
        self.cfg = cfg
        self.render_size = render_size
        self.sem_size = sem_size
        gens = [torch.Generator().manual_seed(seed + k) for k in range(3)]
        self.decoder = decoder if decoder is not None else init_lecun_normal_(
            NRDecoder(cfg, sem_dim=vit.embed_dim if vit is not None else 384),
            gens[2])
        self.vgg = vgg
        self.vit = vit if vit is not None else init_vit_(
            ViTS14(grid_size=sem_size // 14), gens[0])
        # the JBU semantic pyramid exists only in the FeatUp generations
        # (v7/v8, model_nr_v7.py:107-131); v1-v6 read the raw ViT tokens
        self.use_jbu = cfg.version >= 7
        self.jbu = None
        if self.use_jbu:
            self.jbu = jbu if jbu is not None else init_lecun_normal_(
                JBUStack(self.vit.embed_dim), gens[1])
        w = dists_weights or dists.load_pretrained_weights(cfg.dists)
        self.register_buffer("alpha", w.alpha.detach().clone().reshape(-1))
        self.register_buffer("beta", w.beta.detach().clone().reshape(-1))
        for frozen in (self.vgg, self.vit, self.jbu):
            if frozen is not None:
                frozen.requires_grad_(False)
        self.eval()

    @property
    def dists_weights(self) -> dists.DISTSWeights:
        return dists.DISTSWeights(self.alpha, self.beta)

    def _precision(self):
        if self.cfg.dists.compute_dtype == "float32":
            return true_fp32()
        return contextlib.nullcontext()

    def train_precision(self):
        """The precision of a training step, its backward included: true
        fp32 when the VGG or the decoder computes in fp32 (the parity
        path), PyTorch's defaults when both are bf16."""
        if "float32" in (self.cfg.dists.compute_dtype, self.cfg.decoder_dtype):
            return true_fp32()
        return contextlib.nullcontext()

    def _sem_encode(self, render_256: torch.Tensor, render_224: torch.Tensor,
                    sem_tokens: torch.Tensor | None = None):
        """The ViT patch-token map and its JBU pyramid (no grad; an empty
        pyramid for v1-v6). ``sem_tokens``, an (N, gh, gw, D) map from the
        token cache, stands in for the ViT; the JBU still runs, on the
        guidance image (model.py:116-137)."""
        sem_input = (render_224 if self.cfg.vit_model == "dinov2" else render_256).float()
        with torch.no_grad():
            if sem_tokens is not None:
                sem_feats = sem_tokens.float()
            else:
                toks = self.vit(sem_input)
                gh, gw = toks["grid"]
                sem_feats = toks["x_norm_patchtokens"].reshape(
                    sem_input.shape[0], gh, gw, -1)
            pyramid = self.jbu(sem_feats, sem_input) if self.use_jbu else []
            return sem_feats, pyramid

    def encode(self, render_256: torch.Tensor, render_224: torch.Tensor,
               sem_tokens: torch.Tensor | None = None) -> EncoderFeats:
        """Frozen feature extraction (model_nr_v8.py:156-166); NHWC
        images in [0, 1]."""
        with torch.no_grad(), self._precision():
            sem_feats, sem_pyramid = self._sem_encode(render_256, render_224, sem_tokens)
            dists_feats = self.vgg(render_256, torch_dtype(self.cfg.dists.compute_dtype))
        return EncoderFeats(dists_feats, sem_feats, sem_pyramid)

    def _decode(self, feats: EncoderFeats, generator: torch.Generator | None):
        return self.decoder(feats.dists_feats, feats.sem_feats, feats.sem_pyramid,
                            generator, self.vgg if self.cfg.version == 3 else None)

    def apply_decoder(self, feats: EncoderFeats,
                      generator: torch.Generator | None = None):
        """Run the decoder; returns (predicted, score_reg_map). In training
        mode its dropout draws from ``generator`` (none without one) and
        its BatchNorms update their running averages."""
        with self._precision():
            return self._decode(feats, generator)

    def pred_gt_dists_feats(self, feats: EncoderFeats) -> list[torch.Tensor]:
        """Predict the GT DISTS pyramid (model_nr_v8.py:217-236)."""
        return self.apply_decoder(feats)[0]

    def _reg_outputs(self, reg_map: torch.Tensor) -> dict[str, torch.Tensor]:
        """Pool and calibrate the score-regression map (model.py:208-236).
        Channels by version: v3/v4 a scalar residual (model_nr_v4.py:179-188);
        v5 (residual, MAE map) (model_nr_v5.py:181-184); v6 adds the
        calibrated (pred_std, pred_mean), with the fixed affines of
        ``reg_activation`` (model_nr_v6.py:188-203)."""
        k = reg_map.shape[-1]
        if k == 1:
            return {"dists_res": reg_map.mean(dim=(1, 2, 3))}
        mean = reg_map.mean(dim=(1, 2))  # (N, k)
        if k < 4:
            return {"dists_res": mean[:, 0], "mae_map": reg_map[..., 1]}
        out = {"dists_res": mean[:, 0] * 0.1, "mae_map": reg_map[..., 1] * 0.1 + 0.1}
        act = self.cfg.reg_activation
        if act == "relu":
            out["pred_std"] = torch.relu(mean[:, 2] * 0.05 + 0.05)
            out["pred_mean"] = torch.relu(mean[:, 3] * 0.1 + 0.1)
        elif act == "sigmoid":
            out["pred_std"] = torch.sigmoid(mean[:, 2] * 1.0 - 3.0)
            out["pred_mean"] = torch.sigmoid(mean[:, 3] * 0.9 - 2.2)
        else:
            out["pred_std"] = mean[:, 2] * 0.05 + 0.05
            out["pred_mean"] = mean[:, 3] * 0.1 + 0.1
        return out

    def _compose_score(self, feats: EncoderFeats, predicted, reg_map=None):
        """(per-image score, the regression outputs) (model.py:238-254):
        v4's pure regression; otherwise DISTS(render features, predicted
        features), plus ``score_reg_scale`` times the residual where there
        is a head. Both sides go to the statistics as contiguous fp32 NHWC
        (the render's bf16 features upcast exactly, as the JAX package's
        statistics upcast them; the predictions are views of the
        decoder's wider maps)."""
        if predicted is None:  # v4
            reg = self._reg_outputs(reg_map)
            return reg["dists_res"], reg
        feats0 = [f.float().contiguous() for f in feats.dists_feats]
        feats1 = [p.float().contiguous() for p in predicted]
        score = dists.score_from_feats(self.dists_weights, feats0, feats1,
                                       self.cfg.dists)
        if reg_map is None:
            return score, {}
        reg = self._reg_outputs(reg_map)
        return score + self.cfg.score_reg_scale * reg["dists_res"], reg

    def forward_from_feats(self, feats: EncoderFeats) -> torch.Tensor:
        """Per-image NR score (model_nr_v8.py:239-246)."""
        predicted, reg_map = self.apply_decoder(feats)
        return self._compose_score(feats, predicted, reg_map)[0]

    def forward(self, render_256: torch.Tensor, render_224: torch.Tensor,
                sem_tokens: torch.Tensor | None = None) -> torch.Tensor:
        """(N,) NR scores of NHWC renders at 256² and 224² in [0, 1]
        (``sem_tokens``: cached ViT tokens in place of the ViT)."""
        return self.forward_from_feats(self.encode(render_256, render_224, sem_tokens))

    def forward_normalized(self, render_256: torch.Tensor, render_224: torch.Tensor):
        """v6's (score, normalized) forward (model_nr_v6.py:227-240):
        normalized = (score − pred_mean) / (pred_std + 1e-7); the score
        twice for the generations without the calibration head."""
        feats = self.encode(render_256, render_224)
        predicted, reg_map = self.apply_decoder(feats)
        score, reg = self._compose_score(feats, predicted, reg_map)
        if "pred_std" not in reg:
            return score, score
        return score, (score - reg["pred_mean"]) / (reg["pred_std"] + 1e-7)

    def score_map_l1(self, predicted_image: torch.Tensor, render_256: torch.Tensor,
                     score_map: torch.Tensor) -> torch.Tensor:
        """The score-map objective's L1 (model.py:371-397): the ADISTS map of
        the clipped predicted image against the render (in that order: the
        metric is asymmetric), ``-log10(max(map, 1e-6))``, against the
        target's channel 1 (3-channel maps) or 0, resized bilinearly to the
        map's size when they differ. The T/S map takes its plain version:
        the kernel has no backward."""
        cfg = self.cfg
        pred_img = predicted_image.float().clamp(0.0, 1.0)
        amap = adists.forward(self.vgg, pred_img, render_256,
                              ADISTSConfig(compute_dtype=cfg.dists.compute_dtype,
                                           fused_tsd=False), as_map=True)
        pred_log = -torch.log10(amap.clamp_min(1e-6))
        target = score_map.float()
        if target.ndim == 4:
            target = target[..., 1] if target.shape[-1] >= 3 else target[..., 0]
        if tuple(target.shape[1:3]) != tuple(pred_log.shape[1:3]):
            target = resize_bilinear(target[..., None], pred_log.shape[1],
                                     pred_log.shape[2])[..., 0]
        return (pred_log - target).abs().mean()

    def losses(self, gt_image: torch.Tensor, render_256: torch.Tensor,
               render_224: torch.Tensor, generator: torch.Generator | None = None,
               score_std: torch.Tensor | None = None,
               score_mean: torch.Tensor | None = None,
               score_map: torch.Tensor | None = None,
               sem_tokens: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """Self-supervised training losses (model_nr_v8.py:250-274; the JAX
        package's ``losses``, model.py:289-399), NHWC images in [0, 1]:
        ``l1``; ``mae_reg_l1_loss`` (v5/v6, against |gt − render| averaged
        over channels); ``dists_std_l1`` and ``dists_mean_l1`` (v6, with
        ``score_std`` / ``score_mean``); ``dists_pref2ref`` (all but v4);
        ``re_encode`` when ``re_encode_coeff > 0``; ``score_map_l1`` with
        ``score_map``; and ``combined``, the one to minimise. With
        ``generator`` the decoder's dropout is on (in training mode);
        without, the losses are deterministic. The render and the ground
        truth go through one VGG stream; the ground-truth DISTS score is a
        target (no grad), and the only gradient is the decoder's. Its parts
        run in the profiler ranges ``nr.encode``, ``nr.decoder_fwd``,
        ``nr.losses`` and, with a score map, ``nr.score_map``."""
        cfg = self.cfg
        n = render_256.shape[0]
        dtype = torch_dtype(cfg.dists.compute_dtype)
        w = self.dists_weights
        with self.train_precision():
            with torch.no_grad(), record_function("nr.encode"):
                sem_feats, sem_pyramid = self._sem_encode(render_256, render_224,
                                                          sem_tokens)
                both = self.vgg(torch.cat([render_256, gt_image]), dtype)
                feats = EncoderFeats([f[:n] for f in both], sem_feats, sem_pyramid)
                gt_feats = [f[n:].float().contiguous() for f in both]
                gt_score = dists.score_from_feats(
                    w, gt_feats, [f.float().contiguous() for f in feats.dists_feats],
                    cfg.dists)
            with record_function("nr.decoder_fwd"):
                predicted, reg_map = self._decode(feats, generator)
            with record_function("nr.losses"):
                score, reg = self._compose_score(feats, predicted, reg_map)
                l1 = (score - gt_score).abs().mean()
                losses = {"l1": l1}
                l1_total = l1
                if "mae_map" in reg:
                    gt_mae = (gt_image - render_256).abs().mean(dim=-1)
                    losses["mae_reg_l1_loss"] = (reg["mae_map"] - gt_mae).abs().mean()
                    l1_total = l1_total + losses["mae_reg_l1_loss"]
                if "pred_std" in reg and score_std is not None:
                    losses["dists_std_l1"] = (reg["pred_std"] - score_std).abs().mean()
                    losses["dists_mean_l1"] = (reg["pred_mean"] - score_mean).abs().mean()
                    l1_total = l1_total + losses["dists_std_l1"] + losses["dists_mean_l1"]
                if predicted is None:  # v4: no feature prediction
                    losses["combined"] = l1_total
                    return losses
                pref2ref = dists.score_from_feats(
                    w, [p.float().contiguous() for p in predicted], gt_feats,
                    cfg.dists, batch_average=True)
                c = cfg.dists_pref2ref_coeff
                losses["dists_pref2ref"] = pref2ref
                combined = c * pref2ref + (1.0 - c) * l1_total
                if cfg.re_encode_coeff > 0:
                    # re-encode the predicted image through the frozen VGG
                    # and pull the predicted features toward it
                    re_feats = self.vgg(predicted[0].clamp(0.0, 1.0), dtype)
                    re_loss = sum((rf.float() - pf.float()).abs().mean()
                                  for rf, pf in zip(re_feats[1:], predicted[1:])
                                  ) / (len(predicted) - 1)
                    losses["re_encode"] = re_loss
                    combined = combined + cfg.re_encode_coeff * re_loss
            if score_map is not None:
                with record_function("nr.score_map"):
                    sm_l1 = self.score_map_l1(predicted[0], render_256, score_map)
                losses["score_map_l1"] = sm_l1
                combined = combined + cfg.score_map_coeff * sm_l1
            losses["combined"] = combined
        return losses
