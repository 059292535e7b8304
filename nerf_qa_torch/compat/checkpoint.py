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
without ``state.pt``) raises: reading orbax needs JAX, so it is not
ported (ROADMAP Queue 1, "Not to port").
"""
from __future__ import annotations

import os
import signal
from typing import Any

import numpy as np
import torch

# Model-geometry format version, stamped into every checkpoint dir: the
# JAX package's CHECKPOINT_FORMAT (the torch-exact alignment), which the
# port's layers reproduce.
CHECKPOINT_FORMAT = 2
STATE_FILE = "state.pt"

ORBAX_NOT_PORTED = ("a JAX orbax checkpoint cannot be read without JAX, so "
                    "reading one is not ported (ROADMAP Queue 1, \"Not to port\").")


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
                         f"{ORBAX_NOT_PORTED}")
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


def _fr_head_from_state(state) -> dict[str, np.ndarray]:
    """model_stats.py:45-60 head parameters (b1..b4 / dists_weight+bias)
    as ``head.<name>`` arrays."""
    out: dict[str, np.ndarray] = {}
    for torch_key, ours in [
        ("b1", "b1"), ("b2", "b2"), ("b3", "b3"), ("b4", "b4"),
        ("dists_weight", "weight"), ("dists_bias", "bias"),
    ]:
        if torch_key in state:
            out[f"head.{ours}"] = state[torch_key].detach().float().numpy()
    return out


def convert_fr_model_from_torch(path: str):
    """Full FR ``model.pth`` import: (head, alpha_beta|None, vgg|None).

    The saved NeRFQAModel embeds its frozen DISTS (``dists_model.stageK.*``
    VGG stages + fine-tuned ``dists_model.alpha/beta``, model_stats.py:63-68)
    alongside the regression head, so one file restores the whole scoring
    path. ``head``: {'head.b1', ... | 'head.weight', 'head.bias': array};
    ``alpha_beta``: {'alpha', 'beta': (1475,) array}; ``vgg``: the port's
    VGG16Pyramid ``state_dict``, None when the file holds no stages."""
    from nerf_qa_torch.compat.pretrained import _REF_KEY, vgg_state_dict_from_torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    alpha_beta = None
    for pre in ("encoder.dists.", "dists_model.", "dists."):
        if f"{pre}alpha" in sd:
            alpha_beta = {k: sd[f"{pre}{k}"].detach().float().reshape(-1).numpy()
                          for k in ("alpha", "beta")}
            break
    vgg = (vgg_state_dict_from_torch(sd)
           if any(_REF_KEY.search(k) for k in sd) else None)
    return _fr_head_from_state(sd), alpha_beta, vgg
