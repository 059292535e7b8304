"""train_frames_per_s: training frames of the window's steps over the
window's whole host time; a step ends when its loss is on the host."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
