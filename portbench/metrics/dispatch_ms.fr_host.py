"""Host ms a profiled step inside the program's ``fr.score`` spans
(``FrameScorer.score_batch``, from the call to its return): the pace at
which the host issues a batch."""
from portbench.program_spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run.trace, "fr.score")
