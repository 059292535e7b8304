"""fr_host_pairs_per_s: frame pairs fed from the host's memory and scored
in the window, over the window's whole host time."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
