"""Per cent of its roofline that the moments kernel reaches inside
``core.dists.pyramid_stats``: the bound of every stage's pair (bytes read
once, sums written once) over the device time of its kernels."""
from portbench.traces import moments_bound, roofline_share, span_args


def bound(span):
    a = span_args(span)
    return sum(moments_bound(a[i:i + 4], a[i + 4]) for i in range(0, len(a), 5))


def read(run):
    return roofline_share(run.trace, "pb.stats", "moments_", bound)
