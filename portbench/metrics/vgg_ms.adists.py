"""Device ms a step of the kernels, copies and sets launched inside the
program's ``dists.vgg`` spans (``VGG16Pyramid.forward``: both images of
every pair)."""
from portbench.traces import device_ms_per_step


def read(run):
    return device_ms_per_step(run.trace, "dists.vgg")
