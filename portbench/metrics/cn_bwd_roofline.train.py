"""Per cent of its roofline that the ChannelNorm backward reaches in a
training step: the bound of each call's rows, from the program's
``nr.cn_bwd`` span (autograd's thread), over the device time of the
``channel_norm_bwd`` kernels (the backward and its finalize)."""
from portbench.program_spans import cn_bwd_bound
from portbench.traces import roofline_share, span_args


def bound(span):
    rows, c, gelu, itemsize = span_args(span)
    return cn_bwd_bound(rows, c, bool(gelu), itemsize)


def read(run):
    return roofline_share(run.trace, "nr.cn_bwd", "channel_norm_bwd", bound)
