"""Checkpoint save/restore of resumable training state, on ``torch.save``.

Counterpart of ``nerf_qa_tpu/compat/checkpoint.py`` (orbax there). The
layout is the same: ``<ckpt_dir>/step_<N:08d>/`` directories, one per
saved step, and a ``FORMAT`` stamp beside them that restore checks. Each
step directory holds one ``state.pt``, written with ``torch.save`` and read
with ``weights_only=True``. The NR trainer's state is the decoder in the
reference key layout, the optimizer, the epoch, the dropout generator's
state and the DISTS α/β (``tools/train_nr.py``); ``compat/pretrained.
load_nr_torch_file`` reads a checkpoint directory, so ``tools/score.py
--nr --nr-ckpt`` scores with it. A JAX orbax checkpoint (a step directory
without ``state.pt``) raises: reading orbax needs JAX (ROADMAP Queue 1
item 11).
"""
from __future__ import annotations

import os
import signal
from typing import Any

import torch

# Model-geometry format version, stamped into every checkpoint dir: the
# JAX package's CHECKPOINT_FORMAT (the torch-exact alignment), which the
# port's layers reproduce.
CHECKPOINT_FORMAT = 2
STATE_FILE = "state.pt"

ORBAX_TODO = ("a JAX orbax checkpoint cannot be read without JAX: reading "
              "orbax checkpoints is not yet ported (ROADMAP Queue 1 item 11)")


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Save a training state (nested dicts of tensors and Python values)
    under ckpt_dir/step_<N>; return that directory."""
    path = step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(os.path.abspath(ckpt_dir), "FORMAT"), "w") as f:
        f.write(f"{CHECKPOINT_FORMAT}\n")
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None
                       ) -> tuple[int, Any] | None:
    """Restore (step, state), tensors on the CPU; latest step when
    unspecified. None if no checkpoint exists (fresh start). Raises on a
    FORMAT stamp other than the current model geometry, and on an orbax
    step directory."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    fmt_path = os.path.join(os.path.abspath(ckpt_dir), "FORMAT")
    if os.path.exists(fmt_path):
        with open(fmt_path) as f:
            fmt = int(f.read().strip() or 0)
        if fmt != CHECKPOINT_FORMAT:
            raise ValueError(
                f"{ckpt_dir}: checkpoint format {fmt} != current "
                f"{CHECKPOINT_FORMAT} (layer geometry changed; re-train)")
    path = os.path.join(step_dir(ckpt_dir, step), STATE_FILE)
    if not os.path.exists(path):
        raise ValueError(f"{step_dir(ckpt_dir, step)} holds no {STATE_FILE}: "
                         f"{ORBAX_TODO}")
    return step, torch.load(path, map_location="cpu", weights_only=True)


class PreemptionSaver:
    """Save-on-signal hook (SIGTERM, a preemption notice).

    Usage: saver = PreemptionSaver(ckpt_dir); inside the train loop call
    ``saver.maybe_save(step, state)``: it saves when a preemption signal
    arrived since the last call.
    """

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self.signaled = False

        def handler(signum, frame):
            self.signaled = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:  # non-main thread
            pass

    def maybe_save(self, step: int, state: Any) -> bool:
        if not self.signaled:
            return False
        save_checkpoint(self.ckpt_dir, step, state)
        self.signaled = False
        return True
