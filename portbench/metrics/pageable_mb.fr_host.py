"""MB (1e6 bytes) a profiled step that the program's ``fr.h2d:<bytes>:
<pageable>`` spans copy to the card from unpinned host memory."""
from portbench.program_spans import per_step
from portbench.traces import span_args


def pageable_bytes(span):
    n_bytes, pageable = span_args(span)
    return n_bytes if pageable else 0


def read(run):
    b = per_step(run.trace, "fr.h2d", pageable_bytes)
    return None if b is None else b / 1e6
