"""Model FLOPs of the profiled steps (from the configuration's shapes) over
the traced window, as a per cent of the H100's bf16 dense peak."""
from portbench.traces import mfu


def read(run):
    return mfu(run.trace, run.entry.flops_per_step)
