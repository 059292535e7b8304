"""Per cent of the traced window in which no kernel, copy or set ran on
the device (1 - the union of their intervals / the window)."""


def read(run):
    share = run.trace.idle_share() if run.trace is not None else None
    return None if share is None else 100.0 * share
