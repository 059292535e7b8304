"""Model FLOPs of the profiled steps (the pyramid's convolutions of both
images of every pair, from the configuration's shapes) over the traced
window, as a per cent of the H100's bf16 dense peak: the whole step's
share."""
from portbench.traces import mfu


def read(run):
    return mfu(run.trace, run.entry.flops_per_step)
