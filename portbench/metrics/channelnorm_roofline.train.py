"""Per cent of its roofline that the ChannelNorm forward kernel reaches in
each ChannelNorm of a training step: the bound of the call's rows, from
the program's ``nr.cn`` span, over the device time of
``channel_norm_kernel``."""
from portbench.traces import cn_bound, roofline_share, span_args


def bound(span):
    rows, c, gelu, itemsize = span_args(span)
    return cn_bound(rows, c, bool(gelu), itemsize)


def read(run):
    return roofline_share(run.trace, "nr.cn", "channel_norm_kernel", bound)
