"""Trace arithmetic shared by the metric readers: intervals, span
attribution, percentiles, the published peaks and the roofline bounds.

A traced run exports ``torch.profiler``'s chrome trace and reads it into a
:class:`Trace`: the device events (kernels, copies, sets) with the host
time of the call that launched each, and the host spans (``record_function``
ranges: the port's own ``nr.*`` / ``fr.*`` and the benchmark's ``pb.*``).
A device event belongs to every span whose host interval holds its launch,
on any thread (autograd launches the backward from its own).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

JBU_K = 32  # range-projection channels of FeatUp's JBU (key_dim)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals; overlaps count once."""
    total, end = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The sub-intervals of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    i = int(math.floor(pos))
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (pos - i)


@dataclass
class DeviceEvent:
    name: str
    start: float  # us, profiler clock
    dur: float  # us
    launch: float | None  # host time of the launching call, us


@dataclass
class Span:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    device: list[DeviceEvent] = field(default_factory=list)
    spans: list[Span] = field(default_factory=list)
    host_ops: list[Span] = field(default_factory=list)

    @classmethod
    def from_chrome(cls, events: list[dict]) -> "Trace":
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        out = cls()
        for e in events:
            cat = e.get("cat")
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                out.device.append(DeviceEvent(
                    str(e.get("name", "")), float(e["ts"]), float(e.get("dur", 0.0)),
                    launched.get(e.get("args", {}).get("correlation"))))
            elif cat == "user_annotation":
                out.spans.append(Span(str(e["name"]), float(e["ts"]),
                                      float(e["ts"]) + float(e.get("dur", 0.0))))
            elif cat == "cpu_op":
                out.host_ops.append(Span(str(e["name"]), float(e["ts"]),
                                         float(e["ts"]) + float(e.get("dur", 0.0))))
        out.device.sort(key=lambda d: d.start)
        out.spans.sort(key=lambda s: s.start)
        return out

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_chrome(json.load(f)["traceEvents"])

    def spans_named(self, prefix: str) -> list[Span]:
        """Spans whose name is ``prefix`` or starts with ``prefix + ':'``."""
        return [s for s in self.spans
                if s.name == prefix or s.name.startswith(prefix + ":")]

    def window(self) -> tuple[float, float] | None:
        """The traced window: from the first timed step's start to the last
        one's end (the benchmark's ``pb.step`` spans)."""
        steps = self.spans_named("pb.step")
        if not steps:
            return None
        return steps[0].start, max(s.end for s in steps)

    def steps(self) -> int:
        return len(self.spans_named("pb.step"))

    def launched_in(self, span: Span, name_part: str | None = None) -> list[DeviceEvent]:
        """Device events launched inside ``span``'s host interval (by name
        when ``name_part`` is given)."""
        return [d for d in self.device
                if d.launch is not None and span.start <= d.launch <= span.end
                and (name_part is None or name_part in d.name)]

    def device_us_in(self, prefix: str, name_part: str | None = None) -> float | None:
        """Device time of what the spans named ``prefix`` launched, summed
        over those spans; None when there is no such span."""
        spans = self.spans_named(prefix)
        if not spans:
            return None
        return sum(d.dur for s in spans for d in self.launched_in(s, name_part))

    def busy_us(self) -> float:
        w = self.window()
        if w is None:
            return 0.0
        lo, hi = w
        return union_length([(max(d.start, lo), min(d.start + d.dur, hi))
                             for d in self.device
                             if d.start + d.dur > lo and d.start < hi])

    def idle_share(self) -> float | None:
        w = self.window()
        if w is None or w[1] <= w[0]:
            return None
        return 1.0 - self.busy_us() / (w[1] - w[0])

    def top_device_ops(self, k: int = 10) -> list[list]:
        """The k device operations with the most time, [name, seconds]."""
        totals: dict[str, float] = {}
        for d in self.device:
            totals[d.name] = totals.get(d.name, 0.0) + d.dur
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], us / 1e6] for name, us in ranked]

    def idle_gaps(self, k: int = 10, longest: int = 200) -> list[list]:
        """The ``longest`` idle gaps of the device inside the window, their
        time summed by what the host was doing (the innermost span open at
        each gap's middle, else the outermost host operation, else 'host'),
        the k largest sums, [name, seconds]."""
        w = self.window()
        if w is None:
            return []
        totals: dict[str, float] = {}
        found = gaps([(d.start, d.start + d.dur) for d in self.device], *w)
        for a, b in sorted(found, key=lambda g: g[0] - g[1])[:longest]:
            mid = 0.5 * (a + b)
            inner = [s for s in self.spans if s.start <= mid <= s.end
                     and not s.name.startswith("pb.step")]
            if inner:
                name = min(inner, key=lambda s: s.end - s.start).name.split(":")[0]
            else:
                ops = [s for s in self.host_ops if s.start <= mid <= s.end]
                name = (max(ops, key=lambda s: s.end - s.start).name if ops
                        else "host")
            totals[name] = totals.get(name, 0.0) + (b - a)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], us / 1e6] for name, us in ranked]


def moments_bound(shape, itemsize: int) -> float:
    """Least seconds for one moments call on an (N, H, W, C) pair: both
    inputs read once and the (N, 5, C) fp32 sums written once, or 5
    multiply-adds per element pair at the fp32 rate, whichever is longer."""
    n, h, w, c = shape
    elems = n * h * w * c
    t_bytes = (2 * elems * itemsize + n * 5 * c * 4) / PEAK_BYTES_PER_S
    t_ops = 10 * elems / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops)


def jbu_bound(shape, itemsize: int) -> float:
    """Least seconds for one JBU call on an (N, H, W, C) source: each input
    read once, the fp32 output written once; 49·(2K + 2C) multiply-adds
    plus ~4·49 softmax and normalisation operations per pixel at the fp32
    rate."""
    n, h, w, c = shape
    px = n * h * w
    n_bytes = px * (c + JBU_K) * itemsize + px * c * 4 + 50 * 4
    ops = px * 49 * (2 * JBU_K + 2 * c + 4)
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)


def cn_bound(rows: int, c: int, gelu: bool, itemsize: int) -> float:
    """Least seconds for one ChannelNorm call: the rows read and written
    once, scale and bias read once; about 7 operations per element (mean,
    centred variance, normalise, affine) and 5 more for the GELU."""
    n_bytes = 2 * rows * c * itemsize + 2 * c * 4
    ops = rows * c * (7 + 5 * gelu)
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)


def span_args(span: Span) -> list[int]:
    """The integers a ``pb.*:a:b:...`` span name carries."""
    return [int(v) for v in span.name.split(":")[1:]]


def roofline_share(trace: Trace | None, prefix: str, kernel: str, bound) -> float | None:
    """Per cent of its roofline that a kernel reaches: the least seconds of
    every call (``bound(span)``, from the call's shapes in its span name)
    over the device seconds of the kernels named ``kernel`` launched
    inside those spans. None when no such kernel ran in the trace."""
    if trace is None:
        return None
    spans = trace.spans_named(prefix)
    dev_us = sum(d.dur for s in spans for d in trace.launched_in(s, kernel))
    if not spans or dev_us <= 0:
        return None
    return 100.0 * sum(bound(s) for s in spans) / (dev_us / 1e6)


def device_ms_per_step(trace: Trace | None, prefix: str,
                       name_part: str | None = None) -> float | None:
    """Device ms a profiled step of what the spans named ``prefix``
    launched (by name when ``name_part`` is given); None when the trace has
    no such span or no such event."""
    if trace is None or trace.steps() == 0:
        return None
    us = trace.device_us_in(prefix, name_part)
    return None if not us else us / 1e3 / trace.steps()


def clip_ms_p95(step_s: list[float], clip: int) -> float | None:
    """95th percentile, in ms, of the host time of clips of ``clip``
    consecutive steps (the window's steps in order, cut into whole clips)."""
    clips = [sum(step_s[i:i + clip]) for i in range(0, len(step_s) - clip + 1, clip)]
    return 1e3 * percentile(clips, 95) if clips else None


def mfu(trace: Trace | None, flops_per_step: float) -> float | None:
    """Per cent of the bf16 dense peak: the model FLOPs of the profiled
    steps over the traced window."""
    w = trace.window() if trace is not None else None
    if w is None or w[1] <= w[0]:
        return None
    return 100.0 * flops_per_step * trace.steps() / ((w[1] - w[0]) / 1e6) / PEAK_BF16_FLOPS
