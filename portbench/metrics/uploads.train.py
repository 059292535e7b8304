"""Tensors a profiled step builds on the host and copies to the card: the
program's ``ops.upload`` spans a step (the resize and pooling matrices,
the JBU's spatial Gaussian)."""
from portbench.program_spans import count_per_step


def read(run):
    return count_per_step(run.trace, "ops.upload")
