"""Device-idle ms a profiled step while the host is inside the program's
``fr.h2d`` spans (the frames' copy to the card)."""
from portbench.program_spans import idle_ms_under


def read(run):
    return idle_ms_under(run.trace, "fr.h2d")
