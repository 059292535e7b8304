"""Per cent of its roofline that the JBU kernel reaches in each JBU stage
of a training step: the bound of the call's (N, H, W, C) source, from the
program's ``nr.jbu`` span, over the device time of ``jbu_kernel``."""
from portbench.traces import jbu_bound, roofline_share, span_args


def bound(span):
    n, h, w, c, itemsize = span_args(span)
    return jbu_bound((n, h, w, c), itemsize)


def read(run):
    return roofline_share(run.trace, "nr.jbu", "jbu_kernel", bound)
