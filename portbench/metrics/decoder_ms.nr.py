"""Device ms a step of the kernels, copies and sets launched inside the
``pb.decoder`` spans of the profiled steps."""
from portbench.traces import device_ms_per_step


def read(run):
    return device_ms_per_step(run.trace, "pb.decoder")
