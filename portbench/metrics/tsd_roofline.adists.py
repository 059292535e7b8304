"""Per cent of its roofline that the windowed T/S kernel reaches: the
bound of every call (``configs/adists.tsd_bound`` of the pair's shape and
itemsize, from the program's ``adists.tsd:<n>:<h>:<w>:<c>:<itemsize>``
span) over the device time of the kernels named ``tsd_`` launched inside
those spans (``tsd_kernel``, and ``tsd_sum_groups`` where the plan splits
the channels)."""
from portbench.harness import HERE, load_module
from portbench.traces import roofline_share, span_args


def bound(span):
    a = span_args(span)
    return load_module(HERE / "configs" / "adists.py").tsd_bound(a[:4], a[4])


def read(run):
    return roofline_share(run.trace, "adists.tsd", "tsd_", bound)
