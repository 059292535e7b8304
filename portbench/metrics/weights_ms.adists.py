"""Device ms a step of what the program's ``adists.weights`` spans launch:
the entropy channel weights of the distorted frames' pyramid (fp32)."""
from portbench.traces import device_ms_per_step


def read(run):
    return device_ms_per_step(run.trace, "adists.weights")
