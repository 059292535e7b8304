"""The ``adists`` configuration: the VGG16 pyramid's weights from the seed
and the model FLOPs of a frame pair, as the ``dists`` configuration has
them (the same pyramid), and the least time of one windowed T/S call."""
from __future__ import annotations

from portbench.harness import HERE, load_module
from portbench.traces import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

_dists = load_module(HERE / "configs" / "dists.py")
vgg_state = _dists.vgg_state
pair_flops = _dists.pair_flops


def tsd_bound(shape, itemsize: int) -> float:
    """Least seconds for one windowed T/S call on an (N, H, W, C) pair: the
    pair read once, ps, the weights and both scales read once, the map
    written once; per channel 4 operations per input pixel, 21 taps × 4
    moments of multiply-adds in the H pass (Hk·W outputs) and in the W pass
    (Hk·Wk outputs), and ~20 operations of T, S and the blend per output,
    at the fp32 rate (four moments carry the definition's five: the scaled
    variances enter S only as their sum)."""
    n, h, w, c = shape
    hk, wk = h - 20, w - 20
    n_bytes = 2 * n * h * w * c * itemsize + 2 * n * hk * wk * 4 + 3 * n * c * 4
    ops = n * c * (4 * h * w + 168 * hk * w + 188 * hk * wk)
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)
