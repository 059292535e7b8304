"""Device ms a step of the copies from the host to the card launched in
the profiled steps: the frames' way onto the card."""
from portbench.traces import device_ms_per_step


def read(run):
    return device_ms_per_step(run.trace, "pb.step", "HtoD")
