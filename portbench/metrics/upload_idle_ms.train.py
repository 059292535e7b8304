"""Device-idle ms a profiled step while the host is inside the program's
``ops.upload`` spans (building a matrix on the host and copying it)."""
from portbench.program_spans import idle_ms_under


def read(run):
    return idle_ms_under(run.trace, "ops.upload")
