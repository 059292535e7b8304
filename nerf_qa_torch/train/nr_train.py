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
device. The v1-v6 decoders' BatchNorm running averages are buffers of the
decoder (the JAX trainer's ``state``): they update in each training step
and travel in the decoder's ``state_dict``. Steps take the ``gt``
objective (with the per-frame DISTS std / mean targets of v6), the
score-map objective (``train_step_score_map``), or cached ViT tokens in
place of the ViT (``sem_tokens``). It runs on the card unless the caller
asks for another device; on the card the decoder's ChannelNorms launch the
forward and backward kernels and the JBU stack its kernel.

With a mesh (``parallel/mesh.py``) a step computes the unsharded step's
function over the global batch: each data shard runs ``losses`` on its
rows, in a thread of its own (``parallel.mesh.ShardGroup``), on its
device's copy of the model (``parallel.mesh.replicate``; the copies take
the decoder's weights before each step), and the global losses are the
shards' means weighted by their rows. Each shard passes its
``parallel.mesh.Shard`` down the model in place of the generator; it
holds the two couplings of the rows: dropout draws the global batch's
masks from the one generator and keeps the shard's rows, and the v1-v6
BatchNorms normalise with the global batch statistics. One backward
reaches every shard; the copies' gradients are added to the trainer's
decoder. The mesh stays within one process (a mesh with a process group
is refused): as with the JAX tool, ``tools/train_nr.py``'s processes each
train on their own slice.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from nerf_qa_torch.config import TrainConfig, resolve_device
from nerf_qa_torch.logging.metrics import MetricAggregator
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.layers import generator_at, init_lecun_normal_
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.parallel import mesh as meshlib
from nerf_qa_torch.train.schedules import make_schedule
from nerf_qa_torch.utils.profiling import span


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
                 device: str | torch.device | None = None,
                 mesh: meshlib.Mesh | None = None):
        if mesh is not None and mesh.group is not None:
            raise ValueError("NRTrainer's mesh stays within one process; "
                             "train_nr's processes train their own slices")
        self.mesh = mesh
        self.device = mesh.primary if mesh is not None else resolve_device(device)
        self.model = model.to(self.device)
        self._replicas: dict[torch.device, NRModel] | None = None
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
        self._replicas = None
        cfg = self.train_cfg
        self.optimizer = torch.optim.Adam(
            self.model.decoder.parameters(), lr=self.schedule(0),
            betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)
        self.step = 0
        if self.generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, torch.float32, non_blocking=True)

    def _step(self, gt, render_256, render_224, **kw) -> dict[str, torch.Tensor]:
        gt, r256, r224 = (self._to_device(a) for a in (gt, render_256, render_224))
        kw = {k: None if v is None else self._to_device(v) for k, v in kw.items()}
        self.model.decoder.train()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        with self.model.train_precision():
            if self.mesh is None:
                losses = self.model.losses(gt, r256, r224, generator=self.generator,
                                           **kw)
            else:
                losses = self._sharded_losses(gt, r256, r224, kw)
            with span("nr.backward"):
                losses["combined"].backward()
                if self.mesh is not None:
                    self._reduce_grads()
        with span("nr.optimizer"):
            self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def _shard_models(self) -> dict[torch.device, NRModel]:
        """The model each device of the mesh runs (``replicate``: the
        trainer's on its device, a copy elsewhere), the copies' decoder
        and α/β loaded from the trainer's."""
        if self._replicas is None:
            self._replicas = meshlib.replicate(self.mesh, self.model)
        with torch.no_grad():
            for copy_ in self._replicas.values():
                if copy_ is not self.model:
                    copy_.decoder.load_state_dict(self.model.decoder.state_dict())
                    copy_.alpha.copy_(self.model.alpha)
                    copy_.beta.copy_(self.model.beta)
        return self._replicas

    def _sharded_losses(self, gt, r256, r224, kw) -> dict[str, torch.Tensor]:
        """The global batch's losses from its data shards (module
        docstring). The batch must split evenly over the data axis."""
        mesh = self.mesh
        n = gt.shape[0]
        slices = meshlib.data_sharding(mesh, n)
        models = self._shard_models()
        group = meshlib.ShardGroup(len(slices))
        start = self.generator.get_state()
        shards = [meshlib.Shard(group, i, sl, n, self.generator if i == 0
                                else generator_at(self.generator, start))
                  for i, sl in enumerate(slices)]

        def shard(i: int) -> dict[str, torch.Tensor]:
            dev = mesh.data_devices[i]
            rows = slices[i]
            args = meshlib.to_device(
                (gt[rows], r256[rows], r224[rows],
                 {k: None if v is None else v[rows] for k, v in kw.items()}), dev)
            model = models[dev]
            model.decoder.train()
            return model.losses(*args[:3], generator=shards[i], **args[3])

        results = group.run(shard)
        return {key: sum(r[key].to(self.device) * ((sl.stop - sl.start) / n)
                         for r, sl in zip(results, slices))
                for key in results[0]}

    def _reduce_grads(self) -> None:
        """Add the copies' decoder gradients to the trainer's."""
        params = list(self.model.decoder.parameters())
        for copy_ in self._replicas.values():
            if copy_ is self.model:
                continue
            for p, q in zip(params, copy_.decoder.parameters()):
                if q.grad is not None:
                    g = q.grad.to(self.device)
                    p.grad = g if p.grad is None else p.grad + g
                    q.grad = None

    def train_step(self, gt, render_256, render_224, score_std=None, score_mean=None,
                   sem_tokens=None) -> dict[str, torch.Tensor]:
        """One Adam step on the decoder from a batch of NHWC images in
        [0, 1] (numpy or tensors); returns the detached losses. ``score_std``
        / ``score_mean``: the per-frame DISTS targets of v6's calibration
        head (zeros when not given, as the JAX trainer passes);
        ``sem_tokens``: cached ViT tokens in place of the ViT. The step runs
        in the span ``nr.train_step``; the backward and the update in
        ``nr.backward`` and ``nr.optimizer``, after ``losses``' own."""
        with span("nr.train_step"):
            if score_std is None:
                score_std = score_mean = torch.zeros((np.shape(gt)[0],),
                                                     device=self.device)
            return self._step(gt, render_256, render_224, score_std=score_std,
                              score_mean=score_mean, sem_tokens=sem_tokens)

    def train_step_score_map(self, gt, render_256, render_224,
                             score_map) -> dict[str, torch.Tensor]:
        """One Adam step of the score-map objective (mode 'score-map'
        batches: the decoded ``-log10`` ADISTS map beside the images;
        nr_train.py:120-165)."""
        return self._step(gt, render_256, render_224, score_map=score_map)

    def train_epoch(self, batches: Iterable,
                    aggregator: MetricAggregator | None = None) -> None:
        """Batches of (gt_256, render_256, render_224[, ...])
        (train-nr.py:270-296 shape)."""
        for batch in batches:
            losses = self.train_step(*batch[:3])
            if aggregator is not None:
                aggregator.add({k: float(v) for k, v in losses.items()})

    def score_frames(self, render_256, render_224, sem_tokens=None) -> np.ndarray:
        """Per-frame NR scores of one batch, decoder in eval mode (the v1-v6
        BatchNorms on their running averages)."""
        self.model.decoder.eval()
        with torch.no_grad():
            if self.mesh is None:
                toks = None if sem_tokens is None else self._to_device(sem_tokens)
                return self.model(self._to_device(render_256),
                                  self._to_device(render_224), toks).cpu().numpy()
            models = self._shard_models()
            scores = []
            for dev, (r256, r224, toks) in zip(
                    self.mesh.data_devices,
                    meshlib.shard_batch(self.mesh, (render_256, render_224, sem_tokens))):
                models[dev].decoder.eval()
                scores.append(models[dev](r256.float(), r224.float(),
                                          toks).cpu().numpy())
            return np.concatenate(scores)

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
        """The resumable state: the decoder (reference key layout, the
        BatchNorm running averages included), the optimizer, the step, the
        dropout generator and the DISTS α/β."""
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
