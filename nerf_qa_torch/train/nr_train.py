"""No-reference trainer.

Counterpart of ``nerf_qa_tpu/train/nr_train.py``. Reference behaviour:
train-nr.py — Adam over the NR decoder only (encoder frozen), per-epoch
loss aggregation (MetricAggregator), video scoring by the mean frame
score (train-nr.py:305-315), scene-holdout validation split (:231-244).

The JAX trainer threads (params, state, opt_state, rng) through a jitted
step; here the trainer owns them: the decoder inside the model, a
``torch.optim.Adam`` over the decoder's parameters only (no weight decay:
the same update as optax's ``adam`` — bias-corrected moments, eps outside
the square root), the learning-rate schedule written into the optimizer
before each step (optax evaluates it at the update count), and the
dropout generator, an explicit ``torch.Generator`` on the trainer's
device. It runs on the card unless the caller asks for another device; on
the card the decoder's ChannelNorms launch the forward and backward
kernels and the JBU stack its kernel.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch.profiler import record_function

from nerf_qa_torch.config import TrainConfig, resolve_device
from nerf_qa_torch.logging.metrics import MetricAggregator
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.train.schedules import make_schedule


def scene_holdout_split(scenes, holdout_scenes: Iterable[str], methods=None,
                        blacklist_methods: Iterable[str] = ()):
    """Train/val split by scene with a method blacklist
    (train-nr.py:231-244 semantics). Returns boolean masks."""
    scenes = np.asarray(scenes)
    holdout = set(holdout_scenes)
    val = np.array([s in holdout for s in scenes])
    train = ~val
    if methods is not None and blacklist_methods:
        bad = np.array([m in set(blacklist_methods) for m in np.asarray(methods)])
        train &= ~bad
    return train, val


class NRTrainer:
    """Trains ``model.decoder``; ``init`` (or ``set_decoder``) must run
    before the first step."""

    def __init__(self, model: NRModel,
                 train_cfg: TrainConfig = TrainConfig(batch_size=4),
                 steps_per_epoch: int = 100,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_cfg = train_cfg
        self.schedule = make_schedule(train_cfg, steps_per_epoch)
        self.optimizer: torch.optim.Adam | None = None
        self.generator: torch.Generator | None = None
        self.step = 0

    def init(self, seed: int | None = None) -> None:
        """A fresh decoder, built as the JAX trainer's is (qkv bias and
        LayerScale at 1.0 in its transformer blocks, lecun-normal weights
        drawn from ``seed``, default ``train_cfg.seed``), a fresh Adam and
        the dropout generator seeded with ``train_cfg.seed``."""
        seed = self.train_cfg.seed if seed is None else seed
        decoder = NRDecoder(self.model.cfg, sem_dim=self.model.vit.embed_dim,
                            qkv_bias=True, layer_scale=True)
        self.set_decoder(init_lecun_normal_(decoder, torch.Generator().manual_seed(seed)))
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)

    def set_decoder(self, decoder: NRDecoder) -> None:
        """Train ``decoder`` from step 0 with a fresh optimizer."""
        self.model.decoder = decoder.to(self.device)
        cfg = self.train_cfg
        self.optimizer = torch.optim.Adam(
            self.model.decoder.parameters(), lr=self.schedule(0),
            betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)
        self.step = 0
        if self.generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, torch.float32, non_blocking=True)

    def train_step(self, gt, render_256, render_224) -> dict[str, torch.Tensor]:
        """One Adam step on the decoder from a batch of NHWC images in
        [0, 1] (numpy or tensors); returns the detached losses. The
        backward and the update run in the profiler ranges ``nr.backward``
        and ``nr.optimizer``, after ``losses``' own."""
        gt, r256, r224 = (self._to_device(a) for a in (gt, render_256, render_224))
        self.model.decoder.train()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        with self.model.train_precision():
            losses = self.model.losses(gt, r256, r224, generator=self.generator)
            with record_function("nr.backward"):
                losses["combined"].backward()
        with record_function("nr.optimizer"):
            self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train_epoch(self, batches: Iterable,
                    aggregator: MetricAggregator | None = None) -> None:
        """Batches of (gt_256, render_256, render_224[, ...])
        (train-nr.py:270-296 shape)."""
        for batch in batches:
            losses = self.train_step(*batch[:3])
            if aggregator is not None:
                aggregator.add({k: float(v) for k, v in losses.items()})

    def score_frames(self, render_256, render_224) -> np.ndarray:
        """Per-frame NR scores of one batch, decoder in eval mode."""
        self.model.decoder.eval()
        with torch.no_grad():
            return self.model(self._to_device(render_256),
                              self._to_device(render_224)).cpu().numpy()

    def score_video(self, render_256, render_224, batch_size: int = 4) -> float:
        """Mean frame score over a video (train-nr.py:305-315), in
        fixed-shape batches with the tail padded by its last frame."""
        n = render_256.shape[0]
        scores = []
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            r256, r224 = render_256[lo:hi], render_224[lo:hi]
            if hi - lo < batch_size:
                pad = batch_size - (hi - lo)
                r256 = np.concatenate([r256, np.repeat(r256[-1:], pad, 0)])
                r224 = np.concatenate([r224, np.repeat(r224[-1:], pad, 0)])
            scores.append(self.score_frames(r256, r224)[: hi - lo])
        return float(np.concatenate(scores).mean())

    def state_dict(self) -> dict:
        """The resumable state: the decoder (reference key layout), the
        optimizer, the step, the dropout generator and the DISTS α/β."""
        return {"decoder": self.model.decoder.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "generator": self.generator.get_state(),
                "dists_alpha_beta": {"alpha": self.model.alpha.cpu(),
                                     "beta": self.model.beta.cpu()}}

    def load_state_dict(self, state: dict) -> None:
        """Resume from ``state_dict()``'s output."""
        self.set_decoder(NRDecoder.from_state_dict(
            state["decoder"], self.model.cfg, self.model.vit.embed_dim))
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        with torch.no_grad():
            self.model.alpha.copy_(state["dists_alpha_beta"]["alpha"].reshape(-1))
            self.model.beta.copy_(state["dists_alpha_beta"]["beta"].reshape(-1))
