"""Faults planted under the timed path, for the tests and the calibration
runs that show the output check catches them: each patches the program
for the life of its context and restores it."""
from __future__ import annotations

import contextlib

import torch


def _alter_first(fn, delta: float = 1e-2):
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        out[0] += delta
        return out
    return wrapped


@contextlib.contextmanager
def _patched(owner, attr, value):
    original = owner.__dict__[attr]
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, original)


def answer_altered_fr():
    """FrameScorer's first score of every batch moved by 0.01."""
    from nerf_qa_torch.eval.video_scorer import FrameScorer

    return _patched(FrameScorer, "score_batch", _alter_first(FrameScorer.score_batch))


def answer_altered_nr():
    """NRScorer's first score of every batch moved by 0.01."""
    from nerf_qa_torch.tools.score import NRScorer

    return _patched(NRScorer, "step_batch", _alter_first(NRScorer.step_batch))


def state_unchanged():
    """Adam's step does nothing: every training step leaves the weights."""
    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch():
    """The training losses over the first half of the batch only."""
    from nerf_qa_torch.models.nr.model import NRModel

    losses = NRModel.losses

    def half(self, gt, r256, r224, generator=None, **kw):
        n = gt.shape[0] // 2
        kw = {k: None if v is None else v[:n] for k, v in kw.items()}
        return losses(self, gt[:n], r256[:n], r224[:n], generator, **kw)

    return _patched(NRModel, "losses", half)


def loss_altered():
    """The training step's combined loss, as produced, 5 % too large."""
    from nerf_qa_torch.models.nr.model import NRModel

    losses = NRModel.losses

    def altered(self, *a, **k):
        out = losses(self, *a, **k)
        out["combined"] = out["combined"] * 1.05
        return out

    return _patched(NRModel, "losses", altered)


SETUP_STEPS = 3  # the training cell's checked steps, which set-up drives


def updates_dropped_after_setup():
    """Adam's step does nothing once set-up's checked steps are done: the
    window's updates are lost (a replayed step that drops its update)."""
    step = torch.optim.Adam.step
    calls = [0]

    def dropped(self, closure=None):
        calls[0] += 1
        return step(self, closure) if calls[0] <= SETUP_STEPS else None

    return _patched(torch.optim.Adam, "step", dropped)


def stale_inputs_after_setup():
    """Once set-up's checked steps are done, every training step is fed the
    batch of the last of them again (a replayed step on stale inputs)."""
    from nerf_qa_torch.train.nr_train import NRTrainer

    train_step = NRTrainer.train_step
    seen = []

    def stale(self, *batch, **kw):
        seen.append(batch)
        return train_step(self, *seen[min(len(seen), SETUP_STEPS) - 1], **kw)

    return _patched(NRTrainer, "train_step", stale)


FAULTS = {f.__name__: f for f in (answer_altered_fr, answer_altered_nr, state_unchanged,
                                  half_batch, loss_altered, updates_dropped_after_setup,
                                  stale_inputs_after_setup)}
