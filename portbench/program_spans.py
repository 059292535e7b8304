"""Readers of the program's own spans (``nerf_qa_torch/utils/profiling.span``)
in a traced run: counts and integers a profiled step, host time inside a
span, device-idle time under a span, and the ChannelNorm backward's bound.

Only the spans that start inside the traced window count. Every reader
returns None when the trace has no span of the name, as on a program that
does not emit it.
"""
from __future__ import annotations

from portbench.traces import (PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, Span, Trace, gaps,
                              union_length)


def in_window(trace: Trace | None, prefix: str) -> list[Span]:
    """The spans named ``prefix`` that start inside the traced window."""
    w = trace.window() if trace is not None else None
    if w is None:
        return []
    return [s for s in trace.spans_named(prefix) if w[0] <= s.start <= w[1]]


def per_step(trace: Trace | None, prefix: str, value) -> float | None:
    """The sum of ``value(span)`` over the spans named ``prefix``, over the
    profiled steps; None when there is no such span."""
    spans = in_window(trace, prefix)
    if not spans or trace.steps() == 0:
        return None
    return sum(value(s) for s in spans) / trace.steps()


def count_per_step(trace: Trace | None, prefix: str) -> float | None:
    return per_step(trace, prefix, lambda s: 1)


def host_ms_per_step(trace: Trace | None, prefix: str) -> float | None:
    """Host ms a step inside the spans named ``prefix`` (their union)."""
    spans = in_window(trace, prefix)
    if not spans or trace.steps() == 0:
        return None
    return union_length([(s.start, s.end) for s in spans]) / 1e3 / trace.steps()


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_under(trace: Trace | None, prefix: str) -> float | None:
    """Device-idle ms a profiled step while the host is inside a span named
    ``prefix``: the gaps between the device events inside the traced
    window, intersected with the union of those spans' host intervals."""
    spans = in_window(trace, prefix)
    if not spans or trace.steps() == 0:
        return None
    idle = gaps([(d.start, d.start + d.dur) for d in trace.device], *trace.window())
    under = overlap(merged(idle), merged((s.start, s.end) for s in spans))
    return under / 1e3 / trace.steps()


def cn_bwd_bound(rows: int, c: int, gelu: bool, itemsize: int) -> float:
    """Least seconds for one ChannelNorm backward call: x and the output
    gradient read once and dx written once, scale and bias read and dscale
    and dbias written once; about 20 operations per element (statistics,
    x̂, the two row means, dx, the column sums) and 15 more for the GELU's
    derivative."""
    n_bytes = 3 * rows * c * itemsize + 4 * c * 4
    ops = rows * c * (20 + 15 * gelu)
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)
