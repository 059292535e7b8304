"""Host ms a step from the call into ``NRTrainer.train_step`` to its
return, before the loss is read: the pace at which the host issues a
step (mean over the window's steps)."""


def read(run):
    d = getattr(run.entry, "dispatch_s", None)
    return 1e3 * sum(d) / len(d) if d else None
