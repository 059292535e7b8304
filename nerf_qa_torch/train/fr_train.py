"""Full-reference trainer: L1 MOS regression over DISTS scores.

Counterpart of ``nerf_qa_tpu/train/fr_train.py``. Reference behavior:
run_final.py (the canonical FR trainer) — per-fold GroupKFold-by-scene
CV, Adam with epoch-0 warmup + exponential decay, L1 loss + optional
entropy regularization toward the pretrained α/β distribution, optional
per-step weight projection, per-video test loop feeding the metric
logger.

The JAX trainer threads (params, opt_state) through jitted steps; the
port keeps that interface. ``params`` is ``models/fr.py``'s structure of
leaf tensors on the trainer's device, ``opt_state`` an ``FROptState``
holding a ``torch.optim.Adam`` over it; each step updates both in place
and returns them. Gradients reach the head and α/β only: the VGG pyramid
is frozen and runs without autograd (``fr.pair_stats``), so on the card
the DISTS statistics take the fused moments kernel, six launches per
batch (one per stage, on the dist and ref halves of one pyramid batch).
The step runs in the profiler ranges ``fr.pyramid`` and ``fr.stats``
(``fr.pair_stats``), ``fr.head_loss``, ``fr.backward`` and
``fr.optimizer``. The weight projection is applied in place after every
optimizer call.

With a mesh (``parallel/mesh.py``) a step computes the unsharded step's
function over the global batch. The frozen pyramid and its statistics,
nearly all of the work, run per data shard on the shard's device (six
moments launches a shard; a batch that does not split is padded with its
last row, and the padded rows are dropped). The head is small: the
shards' statistics gather on the mesh's first device and the head's loss
and gradient are taken there, once, over the process's rows. When the
mesh carries a process group, each process's L1 numerator, its weight sum
and its gradient go into one ``all_reduce``, so that every process takes
the gradient of the mean over all processes' rows and ends the step with
the same parameters and Adam state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np
import torch
from torch.profiler import record_function

from nerf_qa_torch.config import FRModelConfig, TrainConfig, resolve_device
from nerf_qa_torch.core import dists
from nerf_qa_torch.models import fr
from nerf_qa_torch.parallel import mesh as meshlib
from nerf_qa_torch.train.schedules import make_schedule

SCHEDULE_FREE = ("sadamw", "schedule_free")


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """optax.contrib.schedule_free_adamw at a constant learning rate, no
    weight decay and weight_lr_power 2 (the JAX trainer's 'sadamw'; the
    reference's schedulefree package, run_final.py / run_test2_sf.py).

    The params hold y; each parameter keeps z and the bias-corrected
    second moment. One step: z' = z − lr·g / (√ν̂ + eps), x = (y − (1 − b1)
    z) / b1 moved toward z' by c = lr² / Σ lr², and y' = b1·x + (1 − b1)
    z'. As the JAX trainer does, the params are evaluated at y."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})
        self.weight_sum = 0.0
        self.max_lr = 0.0
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        self.count += 1
        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            self.max_lr = max(self.max_lr, lr)
            weight = self.max_lr ** 2
            ck = weight / (self.weight_sum + weight)
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["z"] = p.detach().clone()
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                st["nu"].mul_(b2).add_((1 - b2) * g * g)
                nu_hat = st["nu"] / (1 - b2 ** self.count)
                z = st["z"] - lr * g / (nu_hat.sqrt() + eps)
                x = (p - (1 - b1) * st["z"]) / b1
                x = (1 - ck) * x + ck * z
                p.copy_(b1 * x + (1 - b1) * z)
                st["z"] = z
        self.weight_sum += self.max_lr ** 2


@dataclass
class FROptState:
    """The torch optimizer over the FR params' two groups ('head',
    'dists'), the count of updates the schedule reads, and the gradient
    accumulator of ``grad_accum_steps`` (optax.MultiSteps)."""

    opt: torch.optim.Optimizer
    count: int = 0
    mini_step: int = 0
    acc: list[torch.Tensor] = field(default_factory=list)


class FROptimizer:
    """Adam with the ``TrainConfig`` schedule, per-group learning rates
    (the head's scaled by ``head_lr_scale``: the ``get_param_lr``
    superset, SURVEY §2 #7) and, with ``grad_accum_steps = k > 1``,
    optax.MultiSteps: k gradients averaged (Welford, as optax), the Adam
    state and the schedule advancing once every k calls, the params
    unchanged in between. torch's Adam is optax's adam (bias-corrected
    moments, eps outside the square root); the learning rate is written
    into each group before the update, as optax evaluates its schedule at
    the update count. ``optimizer='sadamw'`` (or 'schedule_free') takes
    ``ScheduleFreeAdamW`` at the constant ``lr`` instead, and, as the JAX
    ``make_optimizer`` returns it unwrapped, no schedule, group scale or
    accumulation."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int,
                 head_lr_scale: float = 1.0):
        self.cfg = cfg
        self.schedule_free = cfg.optimizer in SCHEDULE_FREE
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.scales = {"head": head_lr_scale, "dists": 1.0}
        self.every_k = 1 if self.schedule_free else max(1, cfg.grad_accum_steps)

    def init(self, params: dict[str, Any]) -> FROptState:
        groups = fr.param_labels(params)
        groups = [{"params": groups[name], "name": name} for name in ("head", "dists")]
        betas = (self.cfg.beta1, self.cfg.beta2)
        if self.schedule_free:
            return FROptState(ScheduleFreeAdamW(groups, self.cfg.lr, betas, self.cfg.eps))
        return FROptState(torch.optim.Adam(groups, lr=self.schedule(0), betas=betas,
                                           eps=self.cfg.eps))

    def update(self, state: FROptState) -> bool:
        """Consume the gradients on the params' ``.grad`` (a missing one
        is zero, as JAX's); return whether the params moved."""
        leaves = [p for g in state.opt.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        if self.every_k > 1:
            n = state.mini_step
            acc = state.acc or [torch.zeros_like(g) for g in grads]
            state.acc = [a + (g - a) / (n + 1) for g, a in zip(grads, acc)]
            if n < self.every_k - 1:
                state.mini_step += 1
                return False
            grads, state.acc, state.mini_step = state.acc, [], 0
        for p, g in zip(leaves, grads):
            p.grad = g
        if not self.schedule_free:
            for group in state.opt.param_groups:
                group["lr"] = self.schedule(state.count) * self.scales[group["name"]]
        state.opt.step()
        state.opt.zero_grad(set_to_none=True)
        state.count += 1
        return True


def _numpy(a) -> np.ndarray:
    """A batch field (numpy, a list, or a tensor on any device) on the host."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   head_lr_scale: float = 1.0) -> FROptimizer:
    """The JAX package's ``make_optimizer`` (optax there)."""
    return FROptimizer(cfg, steps_per_epoch, head_lr_scale)


class FRTrainer:
    """FR training/eval loops over host-provided numpy (or tensor)
    batches, on the card unless the caller asks for another device."""

    def __init__(
        self,
        vgg: torch.nn.Module,
        model_cfg: FRModelConfig = FRModelConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        steps_per_epoch: int = 100,
        head_lr_scale: float = 1.0,
        dists_weights: dists.DISTSWeights | None = None,
        n_stats: int = 0,
        n_scene_types: int = 0,
        device: str | torch.device | None = None,
        mesh: meshlib.Mesh | None = None,
    ):
        self.mesh = mesh
        self.device = mesh.primary if mesh is not None else resolve_device(device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.vgg = vgg.to(self.device).eval().requires_grad_(False)
        self._vggs = meshlib.replicate(mesh, self.vgg) if mesh is not None else None
        self.n_stats = n_stats
        self.n_scene_types = n_scene_types
        self.original_weights = (
            dists_weights if dists_weights is not None
            else dists.load_pretrained_weights(model_cfg.dists)
        ).to(self.device)
        self.optimizer = make_optimizer(train_cfg, steps_per_epoch, head_lr_scale)

    # -- helpers ----------------------------------------------------------
    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = np.asarray(a)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
        return a.to(self.device, dtype)

    def _optional(self, a, dtype=torch.float32) -> torch.Tensor | None:
        return None if a is None else self._tensor(a, dtype)

    def _pred_loss(self, params, pred, dists_score, targets, sample_weights):
        err = (pred - targets).abs()
        # per-frame weights, e.g. 1/frame_count so each video contributes
        # equally to the epoch gradient (run.py:138-167)
        l1 = (err * sample_weights).sum() / sample_weights.sum()
        loss = l1
        if self.train_cfg.entropy_loss_coeff:
            loss = loss + self.train_cfg.entropy_loss_coeff * fr.entropy_loss(
                params, self.original_weights, self.model_cfg)
        return loss, (pred, dists_score, l1)

    def _step_from_stats(self, params, opt_state, stats_5nc, targets,
                         sample_weights, stats, scene_types):
        with record_function("fr.head_loss"):
            loss, aux = self.loss_fn_cached(params, stats_5nc, targets,
                                            sample_weights, stats, scene_types)
        with record_function("fr.backward"):
            if self.mesh is not None and self.mesh.group is not None:
                loss, aux = self._grads_over_group(params, opt_state, loss, aux,
                                                   sample_weights, targets)
            else:
                loss.backward()
        with record_function("fr.optimizer"):
            self.optimizer.update(opt_state)
            if self.train_cfg.project_weights:
                projected = dists.project_weights(params["dists"],
                                                  self.model_cfg.dists)
                with torch.no_grad():
                    params["dists"].alpha.copy_(projected.alpha)
                    params["dists"].beta.copy_(projected.beta)
        return params, opt_state, loss.detach(), tuple(a.detach() for a in aux)

    def _grads_over_group(self, params, opt_state, loss, aux, sample_weights,
                          targets):
        """Leave on each param's ``.grad`` the gradient of the loss over
        every process's rows: this process's L1 numerator Σ w·|err|, its
        weight sum and the numerator's gradient are summed over the mesh's
        group by one ``all_reduce``, then divided by the global weight sum.
        The entropy term depends on the params only, the same in every
        process, and is added after. Returns the global (loss, aux)."""
        pred, dists_score, l1 = aux
        den = (torch.ones_like(pred) if sample_weights is None
               else self._tensor(sample_weights)).sum()
        leaves = [p for g in opt_state.opt.param_groups for p in g["params"]]
        grads = torch.autograd.grad(l1 * den, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        *grads, num, den = meshlib.all_reduce_sum(
            grads + [(l1 * den).detach().reshape(1), den.reshape(1)], self.mesh.group)
        for p, g in zip(leaves, grads):
            p.grad = g / den
        l1 = (num / den)[0]
        loss = l1
        if self.train_cfg.entropy_loss_coeff:
            ent = self.train_cfg.entropy_loss_coeff * fr.entropy_loss(
                params, self.original_weights, self.model_cfg)
            ent.backward()
            loss = loss + ent.detach()
        return loss, (pred, dists_score, l1)

    # -- public API -------------------------------------------------------
    def loss_fn(self, params, dist_imgs, ref_imgs, targets,
                sample_weights=None, stats=None, scene_types=None):
        """(loss, (pred, dists_score, l1)) of an image-pair batch; the
        graph reaches the head and α/β only."""
        return self.loss_fn_cached(params, self.pair_stats(dist_imgs, ref_imgs),
                                   targets, sample_weights, stats, scene_types)

    def loss_fn_cached(self, params, pair_stats, targets,
                       sample_weights=None, stats=None, scene_types=None):
        """``loss_fn`` over precomputed (5, N, 1475) pair statistics — the
        frozen-pyramid half of DISTS hoisted out of the training loop
        (see fr.forward_from_stats)."""
        targets = self._tensor(targets)
        sample_weights = (torch.ones_like(targets) if sample_weights is None
                          else self._tensor(sample_weights))
        pred, dists_score = fr.forward_from_stats(
            params, pair_stats, self.model_cfg, stats=self._optional(stats),
            scene_types=self._optional(scene_types, torch.int64))
        return self._pred_loss(params, pred, dists_score, targets, sample_weights)

    def init(self, train_dists_scores, train_targets):
        """(params, opt_state): the data-driven head init (on the host),
        the pretrained α/β, a fresh Adam."""
        params = fr.init_params(
            train_dists_scores, train_targets, self.model_cfg,
            dists_weights=self.original_weights, n_stats=self.n_stats,
            n_scene_types=self.n_scene_types,
        )
        params = self.to_device(params)
        return params, self.optimizer.init(params)

    def to_device(self, params: dict[str, Any]) -> dict[str, Any]:
        """Trainable leaf copies of ``params`` on the trainer's device."""
        leaf = lambda t: t.detach().to(self.device, torch.float32).clone().requires_grad_(True)  # noqa: E731
        w = params["dists"]
        return {"head": {k: leaf(v) for k, v in params["head"].items()},
                "dists": dists.DISTSWeights(leaf(w.alpha), leaf(w.beta))}

    def pair_stats(self, dist_imgs, ref_imgs) -> torch.Tensor:
        """(5, N, 1475) moments of an image-pair batch (frozen pyramid),
        per data shard on the mesh's devices when there is a mesh."""
        if self.mesh is None:
            return fr.pair_stats(self.vgg, self._tensor(dist_imgs),
                                 self._tensor(ref_imgs), self.model_cfg)
        n = len(dist_imgs)
        pad = meshlib.pad_to_multiple(n, self.mesh.shape[meshlib.DATA_AXIS]) - n
        if pad:
            dist_imgs = meshlib.pad_tail(dist_imgs, pad)
            ref_imgs = meshlib.pad_tail(ref_imgs, pad)
        shards = meshlib.shard_batch(self.mesh, (dist_imgs, ref_imgs))
        return torch.cat([
            fr.pair_stats(self._vggs[dev], d.float(), r.float(), self.model_cfg
                          ).to(self.device)
            for dev, (d, r) in zip(self.mesh.data_devices, shards)], dim=1)[:, :n]

    def train_step(self, params, opt_state, dist_imgs, ref_imgs, targets,
                   sample_weights=None, stats=None, scene_types=None):
        """One optimizer call on an image-pair batch; returns (params,
        opt_state, loss, (pred, dists_score, l1)), detached."""
        return self._step_from_stats(
            params, opt_state, self.pair_stats(dist_imgs, ref_imgs), targets,
            sample_weights, stats, scene_types)

    def train_step_cached(self, params, opt_state, pair_stats, targets,
                          sample_weights=None, stats=None, scene_types=None):
        """Train step over cached (N, 5, 1475) pair statistics."""
        # the cache stores (N, 5, 1475) so the batch axis leads;
        # score_from_stats wants (5, N, C)
        return self._step_from_stats(
            params, opt_state, self._tensor(pair_stats).transpose(0, 1),
            targets, sample_weights, stats, scene_types)

    def build_stats_cache(self, batches: Iterable) -> dict[str, np.ndarray]:
        """One frozen-VGG pass over (dist, ref, target, video_id) batches
        -> {'stats' (N, 5, 1475), 'targets' (N,), 'video_ids' (N,)}.

        Valid whenever the dataset is deterministic (no per-epoch random
        crops): Test2/LargeQA frame pairs. Afterward every training epoch
        costs O(N·1475) on the α/β+head parameters instead of two VGG16
        forward passes per pair per step.

        Dtype note: the cached moments are stored (and the cached score
        computed) in float32 regardless of ``cfg.compute_dtype``. With
        bfloat16 the pyramid still runs in bf16, but the downstream
        α/β·stats math is fp32 — as the image path's is: both take the
        fp32 moments of the bf16 features."""
        stats_parts, target_parts, vid_parts = [], [], []
        for batch in batches:
            dist_imgs, ref_imgs, targets = batch[:3]
            vids = batch[3] if len(batch) > 3 else np.zeros(len(targets))
            s = self.pair_stats(dist_imgs, ref_imgs)
            stats_parts.append(s.float().transpose(0, 1).cpu().numpy())
            target_parts.append(_numpy(targets).astype(np.float32))
            vid_parts.append(np.atleast_1d(_numpy(vids)))
        return {
            "stats": np.concatenate(stats_parts, axis=0),
            "targets": np.concatenate(target_parts),
            "video_ids": np.concatenate(vid_parts),
        }

    def train_epoch_cached(self, params, opt_state, cache: dict,
                           order: np.ndarray, batch_size: int,
                           logger=None, scene_of_video=None,
                           stats_of_video=None, scene_type_of_video=None):
        """One epoch over a stats cache in ``order`` (a sampler's index
        sequence into the cache's leading axis)."""
        losses = []
        for lo in range(0, len(order), batch_size):
            idx = order[lo:lo + batch_size]
            vids = cache["video_ids"][idx]
            vstats = None
            if stats_of_video is not None:
                vstats = np.stack([
                    stats_of_video[int(v)] for v in vids
                ]).astype(np.float32)
            stypes = None
            if scene_type_of_video is not None:
                stypes = np.asarray(
                    [scene_type_of_video[int(v)] for v in vids], np.int32
                )
            params, opt_state, loss, aux = self.train_step_cached(
                params, opt_state, cache["stats"][idx],
                cache["targets"][idx], stats=vstats, scene_types=stypes,
            )
            losses.append(float(loss))
            if logger is not None:
                pred = aux[0].cpu().numpy()
                targets = cache["targets"][idx]
                logger.add_entries(
                    {
                        "loss": np.full(len(idx), float(loss)),
                        "mse": np.square(pred - targets),
                        "pred_score": pred,
                        "mos": targets,
                    },
                    video_ids=vids,
                    scene_ids=np.asarray([
                        (scene_of_video or {}).get(int(v), "?") for v in vids
                    ]),
                )
        return params, opt_state, float(np.mean(losses)) if losses else 0.0

    def compute_dists_scores(self, batches: Iterable) -> dict:
        """Per-video mean pretrained-DISTS scores over a loader (used for
        head init when the CSV lacks a DISTS column)."""
        scores: dict[Any, list] = {}
        for batch in batches:
            dist_imgs, ref_imgs = batch[0], batch[1]
            video_ids = batch[3] if len(batch) > 3 else np.zeros(len(dist_imgs))
            s = dists.score_from_stats(self.pair_stats(dist_imgs, ref_imgs),
                                       self.original_weights, self.model_cfg.dists)
            for vid, v in zip(np.atleast_1d(_numpy(video_ids)), s.cpu().numpy()):
                scores.setdefault(vid.item(), []).append(float(v))
        return {v: float(np.mean(x)) for v, x in scores.items()}

    def train_epoch(self, params, opt_state, batches: Iterable, logger=None):
        """One epoch over (dist, ref, target, video_id, scene_id) batches
        (run_final.py:168-229 shape)."""
        losses = []
        for batch in batches:
            dist_imgs, ref_imgs, targets = batch[:3]
            params, opt_state, loss, aux = self.train_step(
                params, opt_state, dist_imgs, ref_imgs, targets
            )
            losses.append(float(loss))
            if logger is not None and len(batch) >= 5:
                pred = aux[0].cpu().numpy()
                targets = _numpy(targets)
                logger.add_entries(
                    {
                        "loss": np.full(len(targets), float(loss)),
                        "mse": np.square(pred - targets),
                        "pred_score": pred,
                        "mos": targets,
                    },
                    video_ids=batch[3],
                    scene_ids=batch[4],
                )
        return params, opt_state, float(np.mean(losses)) if losses else 0.0

    def evaluate(self, params, dist_imgs, ref_imgs, stats=None,
                 scene_types=None):
        """(pred, dists_score) of an image-pair batch, no gradients."""
        with torch.no_grad():
            return fr.forward_from_stats(
                params, self.pair_stats(dist_imgs, ref_imgs), self.model_cfg,
                stats=self._optional(stats),
                scene_types=self._optional(scene_types, torch.int64))

    def score_dataloader(self, params, batches: Iterable,
                         stats_of_video=None,
                         scene_type_of_video=None) -> dict:
        """Video-level scoring over an eval loader — the missing
        ``forward_dataloader`` capability (SURVEY §2 #7): per-frame
        forward, concat, then per-video means. ``stats_of_video``:
        optional {video_id: (n_stats,) array} for the stats-conditioned
        head (run_test2_stats.py:195). ``scene_type_of_video``: optional
        {video_id: int} for the scene-type calibration (run_test2.py:218)."""
        preds: dict[Any, list] = {}
        dists_scores: dict[Any, list] = {}
        for batch in batches:
            dist_imgs, ref_imgs = batch[0], batch[1]
            video_ids = np.atleast_1d(_numpy(
                batch[3] if len(batch) > 3 else np.zeros(len(dist_imgs))))
            stats = None
            if stats_of_video is not None:
                stats = np.stack([stats_of_video[int(v)] for v in video_ids]
                                 ).astype(np.float32)
            scene_types = None
            if scene_type_of_video is not None:
                scene_types = np.asarray([scene_type_of_video[int(v)]
                                          for v in video_ids], np.int32)
            pred, ds = self.evaluate(params, dist_imgs, ref_imgs, stats,
                                     scene_types)
            for vid, p, d in zip(video_ids, pred.cpu().numpy(), ds.cpu().numpy()):
                preds.setdefault(vid.item(), []).append(float(p))
                dists_scores.setdefault(vid.item(), []).append(float(d))
        return {
            "pred_score": {v: float(np.mean(x)) for v, x in preds.items()},
            "dists_score": {v: float(np.mean(x)) for v, x in dists_scores.items()},
        }


def group_kfold_splits(groups: np.ndarray, n_splits: int = 4, seed: int = 0):
    """Scene-grouped K-fold indices (run_final.py:231-239). Deterministic
    host-side numpy; equivalent to sklearn GroupKFold (greedy size
    balancing by group frequency)."""
    groups = np.asarray(groups)
    uniq, counts = np.unique(groups, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    fold_sizes = np.zeros(n_splits, np.int64)
    fold_of_group = {}
    for gi in order:
        f = int(np.argmin(fold_sizes))
        fold_of_group[uniq[gi]] = f
        fold_sizes[f] += counts[gi]
    folds = np.array([fold_of_group[g] for g in groups])
    for f in range(n_splits):
        test_idx = np.where(folds == f)[0]
        train_idx = np.where(folds != f)[0]
        yield train_idx, test_idx
