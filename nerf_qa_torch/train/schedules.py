"""LR schedules matching the reference trainers, as plain functions of the
step.

Counterpart of ``nerf_qa_tpu/train/schedules.py`` (optax schedules there;
here a function ``step -> lr`` that the trainer writes into the torch
optimizer's param group before each step, as optax evaluates its schedule
at the update count before the update):

* epoch-0 linear warmup then per-epoch exponential decay
  (run_final.py:178-186, 264: warmup across the first epoch's steps,
  then ExponentialLR(gamma) stepped once per epoch)
* warmup + cosine annealing (run_nerf_qa.py variant; optax's
  ``warmup_cosine_decay_schedule`` written out)
* constant
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_exponential(lr: float, steps_per_epoch: int, epochs: int, gamma: float,
                       warmup_epochs: int = 1) -> Schedule:
    warmup_steps = max(1, warmup_epochs * steps_per_epoch)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * (step + 1) / warmup_steps
        return lr * gamma ** ((step - warmup_steps) // steps_per_epoch + 1)

    return schedule


def warmup_cosine(lr: float, steps_per_epoch: int, epochs: int,
                  warmup_epochs: int = 1) -> Schedule:
    """Linear from lr / warmup_steps to lr over the warmup steps, then a
    cosine decay to 0 over the remaining ``total - warmup_steps`` steps."""
    warmup_steps = max(1, warmup_epochs * steps_per_epoch)
    total = max(warmup_steps + 1, epochs * steps_per_epoch)
    init = lr / warmup_steps
    decay_steps = total - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init + (lr - init) * step / warmup_steps
        count = min(step - warmup_steps, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return schedule


def make_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """The schedule a ``TrainConfig`` names: 'cosine', 'exp' or constant."""
    if cfg.schedule == "cosine":
        return warmup_cosine(cfg.lr, steps_per_epoch, cfg.epochs, cfg.warmup_epochs)
    if cfg.schedule == "exp":
        return warmup_exponential(cfg.lr, steps_per_epoch, cfg.epochs, cfg.gamma,
                                  cfg.warmup_epochs)
    return lambda step: cfg.lr
