"""No-reference quality model (flagship: v8): serving and training.

Counterpart of ``nerf_qa_tpu/models/nr/model.py``. Reference behaviour:
model_nr_v8.py:138-274 —

* encoder (frozen): the ViT (+ JBU semantic pyramid) on the 224² render,
  the DISTS VGG pyramid on the 256² render (:156-166);
* decoder: the transformer context mixer + RefineUp cascade predicting
  the ground-truth DISTS pyramid (:217-236);
* score: DISTS of the render's features against the predicted ones
  (:239-246), through ``core/dists.score_from_feats`` (the CUDA moments
  kernel under ``stats_impl='kernel'``);
* losses (:250-274, the ``gt`` objective of train-nr.py): ``l1`` between
  the predicted score and the ground-truth DISTS score (self-supervised),
  ``dists_pref2ref`` = DISTS(predicted features, GT features), combined by
  ``dists_pref2ref_coeff``, plus the optional ``re_encode`` term.

The encoder runs under ``torch.no_grad()`` with frozen weights. The
decoder is the only trainable part: on the card its ChannelNorms launch
the forward kernel and, under autograd, the backward kernel. The
score-map objective (``losses(score_map=...)``) and the BatchNorm
generations wait for ROADMAP Queue 1 item 11 and raise.

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

from nerf_qa_torch.config import NRModelConfig, torch_dtype, true_fp32
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.featup import JBUStack
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_


class EncoderFeats(NamedTuple):
    dists_feats: list  # 6-level render DISTS pyramid [x, s1..s5], NHWC
    sem_feats: torch.Tensor  # (N, 16, 16, D) low-res semantic map
    sem_pyramid: list  # 6-level JBU semantic pyramid, NHWC fp32


class NRModel(nn.Module):
    """The frozen encoder (VGG pyramid, ViT, JBU stack), the decoder and
    the DISTS α/β in one module. Missing parts are random from ``seed``
    (seeded ``torch.Generator``s); ``render_size / 16`` must equal
    ``sem_size / 14`` so the DISTS stage-5 grid matches the ViT grid."""

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
        # the decoder first: it raises for the generations not yet ported
        self.decoder = decoder if decoder is not None else init_lecun_normal_(
            NRDecoder(cfg, sem_dim=vit.embed_dim if vit is not None else 384),
            gens[2])
        self.vgg = vgg
        self.vit = vit if vit is not None else init_vit_(
            ViTS14(grid_size=sem_size // 14), gens[0])
        self.jbu = jbu if jbu is not None else init_lecun_normal_(
            JBUStack(self.vit.embed_dim), gens[1])
        w = dists_weights or dists.load_pretrained_weights(cfg.dists)
        self.register_buffer("alpha", w.alpha.detach().clone().reshape(-1))
        self.register_buffer("beta", w.beta.detach().clone().reshape(-1))
        for frozen in (self.vgg, self.vit, self.jbu):
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

    def _sem_encode(self, render_256: torch.Tensor, render_224: torch.Tensor):
        """The ViT patch-token map and its JBU pyramid (no grad)."""
        sem_input = (render_224 if self.cfg.vit_model == "dinov2" else render_256).float()
        with torch.no_grad():
            toks = self.vit(sem_input)
            gh, gw = toks["grid"]
            sem_feats = toks["x_norm_patchtokens"].reshape(
                sem_input.shape[0], gh, gw, -1)
            return sem_feats, self.jbu(sem_feats, sem_input)

    def encode(self, render_256: torch.Tensor, render_224: torch.Tensor) -> EncoderFeats:
        """Frozen feature extraction (model_nr_v8.py:156-166); NHWC
        images in [0, 1]."""
        with torch.no_grad(), self._precision():
            sem_feats, sem_pyramid = self._sem_encode(render_256, render_224)
            dists_feats = self.vgg(render_256, torch_dtype(self.cfg.dists.compute_dtype))
        return EncoderFeats(dists_feats, sem_feats, sem_pyramid)

    def apply_decoder(self, feats: EncoderFeats,
                      generator: torch.Generator | None = None):
        """Run the decoder; returns (predicted, score_reg_map). In training
        mode its dropout draws from ``generator`` (none without one)."""
        with self._precision():
            return self.decoder(feats.dists_feats, feats.sem_feats,
                                feats.sem_pyramid, generator)

    def pred_gt_dists_feats(self, feats: EncoderFeats) -> list[torch.Tensor]:
        """Predict the GT DISTS pyramid (model_nr_v8.py:217-236)."""
        return self.apply_decoder(feats)[0]

    def _compose_score(self, feats: EncoderFeats, predicted) -> torch.Tensor:
        """DISTS(render features, predicted features) per image; v7/v8 add
        no regression term. Both sides go to the statistics as contiguous
        fp32 NHWC (the render's bf16 features upcast exactly, as the JAX
        package's statistics upcast them; the predictions are views of
        the decoder's wider maps)."""
        feats0 = [f.float().contiguous() for f in feats.dists_feats]
        feats1 = [p.float().contiguous() for p in predicted]
        return dists.score_from_feats(self.dists_weights, feats0, feats1,
                                      self.cfg.dists)

    def forward_from_feats(self, feats: EncoderFeats) -> torch.Tensor:
        """Per-image NR score (model_nr_v8.py:239-246)."""
        predicted, _ = self.apply_decoder(feats)
        return self._compose_score(feats, predicted)

    def forward(self, render_256: torch.Tensor, render_224: torch.Tensor) -> torch.Tensor:
        """(N,) NR scores of NHWC renders at 256² and 224² in [0, 1]."""
        return self.forward_from_feats(self.encode(render_256, render_224))

    def forward_normalized(self, render_256: torch.Tensor, render_224: torch.Tensor):
        """v6's (score, normalized) forward (model_nr_v6.py:227-240). v7/v8
        have no calibration head, so the normalized score is the score."""
        score = self.forward(render_256, render_224)
        return score, score

    def losses(self, gt_image: torch.Tensor, render_256: torch.Tensor,
               render_224: torch.Tensor, generator: torch.Generator | None = None,
               score_map: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """Self-supervised training losses of v7/v8 (model_nr_v8.py:250-274;
        the JAX package's ``losses``, model.py:289-399), NHWC images in
        [0, 1]: ``l1``, ``dists_pref2ref``, ``re_encode`` when
        ``re_encode_coeff > 0``, and ``combined``, the one to minimise.
        With ``generator`` the decoder's dropout is on (in training mode);
        without, the losses are deterministic. The render and the ground
        truth go through one VGG stream; the ground-truth DISTS score is a
        target (no grad), and the only gradient is the decoder's. Its
        parts run in the profiler ranges ``nr.encode``, ``nr.decoder_fwd``
        and ``nr.losses``."""
        cfg = self.cfg
        if score_map is not None:
            raise NotImplementedError(
                "the score-map objective (--mode score-map) differentiates "
                "ADISTS through the render and is not yet ported (ROADMAP "
                "Queue 1 item 11)")
        n = render_256.shape[0]
        dtype = torch_dtype(cfg.dists.compute_dtype)
        w = self.dists_weights
        with self.train_precision():
            with torch.no_grad(), record_function("nr.encode"):
                sem_feats, sem_pyramid = self._sem_encode(render_256, render_224)
                both = self.vgg(torch.cat([render_256, gt_image]), dtype)
                feats = EncoderFeats([f[:n] for f in both], sem_feats, sem_pyramid)
                gt_feats = [f[n:].float().contiguous() for f in both]
                gt_score = dists.score_from_feats(
                    w, gt_feats, [f.float().contiguous() for f in feats.dists_feats],
                    cfg.dists)
            with record_function("nr.decoder_fwd"):
                predicted, _ = self.decoder(feats.dists_feats, feats.sem_feats,
                                            feats.sem_pyramid, generator)
            with record_function("nr.losses"):
                l1 = (self._compose_score(feats, predicted) - gt_score).abs().mean()
                pref2ref = dists.score_from_feats(
                    w, [p.float().contiguous() for p in predicted], gt_feats,
                    cfg.dists, batch_average=True)
                c = cfg.dists_pref2ref_coeff
                losses = {"l1": l1, "dists_pref2ref": pref2ref}
                combined = c * pref2ref + (1.0 - c) * l1
                if cfg.re_encode_coeff > 0:
                    # re-encode the predicted image through the frozen VGG
                    # and pull the predicted features toward it
                    re_feats = self.vgg(predicted[0].clamp(0.0, 1.0), dtype)
                    re_loss = sum((rf.float() - pf.float()).abs().mean()
                                  for rf, pf in zip(re_feats[1:], predicted[1:])
                                  ) / (len(predicted) - 1)
                    losses["re_encode"] = re_loss
                    combined = combined + cfg.re_encode_coeff * re_loss
                losses["combined"] = combined
        return losses
