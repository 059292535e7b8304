"""No-reference quality model (flagship: v8), serving half.

Counterpart of ``nerf_qa_tpu/models/nr/model.py``. Reference behaviour:
model_nr_v8.py:138-246 —

* encoder (frozen): the ViT (+ JBU semantic pyramid) on the 224² render,
  the DISTS VGG pyramid on the 256² render (:156-166);
* decoder: the transformer context mixer + RefineUp cascade predicting
  the ground-truth DISTS pyramid (:217-236);
* score: DISTS of the render's features against the predicted ones
  (:239-246), through ``core/dists.score_from_feats`` (the CUDA moments
  kernel under ``stats_impl='kernel'``).

The encoder runs under ``torch.no_grad()`` with frozen weights. The
decoder runs in eval mode (dropout off) as built; on the card its
ChannelNorm kernel has no backward yet, so a forward there runs under
``torch.no_grad()``, as ``tools/score.NRScorer`` runs it. ``losses``,
``forward_normalized`` and the BatchNorm generations wait for NR
training (ROADMAP Queue 1 item 11).

Precision: with ``cfg.dists.compute_dtype='float32'`` the whole forward
runs in true fp32 (no TF32), the parity path; with 'bfloat16' the VGG
pyramid runs in bf16 and the rest at PyTorch's defaults on the card
(cuDNN convolutions in TF32, matmuls in fp32).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

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

    def encode(self, render_256: torch.Tensor, render_224: torch.Tensor) -> EncoderFeats:
        """Frozen feature extraction (model_nr_v8.py:156-166); NHWC
        images in [0, 1]."""
        sem_input = render_224 if self.cfg.vit_model == "dinov2" else render_256
        with torch.no_grad(), self._precision():
            toks = self.vit(sem_input.float())
            gh, gw = toks["grid"]
            sem_feats = toks["x_norm_patchtokens"].reshape(
                sem_input.shape[0], gh, gw, -1)
            sem_pyramid = self.jbu(sem_feats, sem_input.float())
            dists_feats = self.vgg(render_256, torch_dtype(self.cfg.dists.compute_dtype))
        return EncoderFeats(dists_feats, sem_feats, sem_pyramid)

    def apply_decoder(self, feats: EncoderFeats):
        """Run the decoder; returns (predicted, score_reg_map)."""
        with self._precision():
            return self.decoder(feats.dists_feats, feats.sem_feats, feats.sem_pyramid)

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
