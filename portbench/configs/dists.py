"""The ``dists`` configuration: the VGG16 pyramid's weights from the seed,
and the model FLOPs of a frame pair, from the sizes in ``dists.json``."""
from __future__ import annotations

import torch

from portbench.weights import layer_rule, seeded_state


def vgg_state(gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """He-normal VGG16 weights and zero biases, in the port's (the
    reference DISTS) key layout."""
    from nerf_qa_torch.core.vgg import VGG16Pyramid

    model = VGG16Pyramid()
    return seeded_state(model, layer_rule(2.0)(model), gen, device)


def stage_sizes(spec: dict, h: int, w: int) -> list[tuple[int, int]]:
    """Spatial size of each VGG stage: the input's, then each L2 pool's
    output, floor((n + 2p - k) / s) + 1."""
    pool = spec["l2pool"]
    sizes = [(h, w)]
    for _ in spec["vgg16_stages"][1:]:
        h, w = ((n + 2 * pool["padding"] - pool["taps"]) // pool["stride"] + 1
                for n in (h, w))
        sizes.append((h, w))
    return sizes


def vgg_macs(spec: dict, h: int, w: int) -> int:
    """Multiply-adds of the thirteen 3x3 convolutions of one image (the
    L2 pools, normalisation and statistics are not counted)."""
    k2 = spec["conv_kernel"] ** 2
    return sum(hh * ww * k2 * cin * cout
               for (hh, ww), convs in zip(stage_sizes(spec, h, w), spec["vgg16_stages"])
               for cin, cout in convs)


def pair_flops(spec: dict, h: int, w: int) -> int:
    """FLOPs of scoring one pair at h x w: both images through the pyramid,
    two FLOPs a multiply-add."""
    return 2 * 2 * vgg_macs(spec, h, w)
