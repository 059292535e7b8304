"""Per cent of its roofline that the windowed γ kernel reaches: the bound
of every call (:func:`gamma_bound` of the stage's shape and itemsize, from
the program's ``adists.gamma:<n>:<h>:<w>:<c>:<itemsize>`` span) over the
device time of the kernels named ``gamma_`` launched inside those spans
(``gamma_kernel``, and ``gamma_sum_groups`` where the plan splits the
channels). A program without the span reads nothing."""
from portbench.traces import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, roofline_share, span_args


def gamma_bound(shape, itemsize: int) -> float:
    """Least seconds for one windowed γ sum over an (N, H, W, C) map: the
    map read once and the (N, Hk, Wk) sum written once; per channel one
    square per input pixel, 21 taps × 2 moments of multiply-adds in the H
    pass (Hk·W outputs) and in the W pass (Hk·Wk outputs), and ~5
    operations of the ratio and the channel sum per output, at the fp32
    rate."""
    n, h, w, c = shape
    hk, wk = h - 20, w - 20
    n_bytes = n * h * w * c * itemsize + n * hk * wk * 4
    ops = n * c * (h * w + 84 * hk * w + 89 * hk * wk)
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)


def bound(span):
    a = span_args(span)
    return gamma_bound(a[:4], a[4])


def read(run):
    return roofline_share(run.trace, "adists.gamma", "gamma_", bound)
