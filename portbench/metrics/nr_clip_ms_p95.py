"""nr_clip_ms_p95: 95th percentile over the window's clips of the host
time to score one clip, the traffic's ``clip_batches`` consecutive batches:
from the call into the entry for its first batch until the last batch's
scores are on the host. A clip spans some hundreds of milliseconds, so the
host clock's error stays small against it."""
from portbench.traces import clip_ms_p95


def read(run):
    return clip_ms_p95(run.step_s, run.entry.ctx.traffic["clip_batches"])
