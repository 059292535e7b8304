"""setup_s: seconds from process start to the first timed step (imports,
the kernel library, weights and inputs, warm-up; host clock)."""


def read(run):
    return run.setup_s
