"""Seeded weights made on the device in one draw.

The benchmark makes every weight itself: one ``torch.randn`` of all the
drawn parameters on the card from a ``torch.Generator`` seeded by the run,
cut into the parameters' shapes and scaled. The program's modules take a
copy through ``load_state_dict``; the plain reference reads the same
dictionary. Only the parameters' names and shapes come from the program.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def fan_in(module: nn.Module, p: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw)
        return p.shape[0] * p.shape[2] * p.shape[3]
    return math.prod(p.shape[1:])


def layer_rule(gain: float) -> Callable[[nn.Module], dict]:
    """std = sqrt(gain / fan_in) for every conv, transposed conv and linear
    weight, zero biases; gain 1 is lecun-normal, 2 He-normal."""

    def stds(model: nn.Module) -> dict:
        out = {}
        for mname, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                pre = f"{mname}." if mname else ""
                out[pre + "weight"] = math.sqrt(gain / fan_in(m, m.weight))
                if m.bias is not None:
                    out[pre + "bias"] = 0.0
        return out

    return stds


def seeded_state(model: nn.Module, stds: dict, gen: torch.Generator,
                 device) -> dict[str, torch.Tensor]:
    """The model's ``state_dict`` with each parameter named in ``stds``
    drawn as N(0, std²) (0: zeros) from one randn on ``device``; other
    entries keep the module's own deterministic values."""
    state = {k: v.detach().to(device).clone() for k, v in model.state_dict().items()}
    drawn = [(k, state[k]) for k in state if stds.get(k)]
    total = sum(t.numel() for _, t in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    for k, t in drawn:
        n = t.numel()
        state[k] = (flat[off:off + n].view(t.shape) * stds[k]).to(t.dtype)
        off += n
    for k, std in stds.items():
        if std == 0.0:
            state[k] = torch.zeros_like(state[k])
    return state
