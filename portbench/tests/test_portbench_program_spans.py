"""The readers of the program's own spans on hand-made chrome traces:
device-idle time under a span, bytes and counts a profiled step from the
spans' integers, host time inside a span, the training cell's rooflines,
and nothing read from a trace without such spans (a program that does not
emit them)."""
import sys

import pytest

from portbench import harness, program_spans, traces
from portbench.harness import Run


class _Entry:
    frames_per_step = 4
    flops_per_step = 1e12


def _run(events):
    trace = traces.Trace.from_chrome(events)
    r = Run(cell="x", seconds=1.0, entry=_Entry(), trace=trace)
    r.steps = trace.steps()
    return r


def _span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _device(events, kernels):
    """Kernels (name, launch, start, dur), each with its launching call."""
    for corr, (name, launch, start, dur) in enumerate(kernels, start=len(events)):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                       "dur": 1, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": start, "dur": dur,
                       "args": {"correlation": corr}})
    return events


def _feed_trace():
    """Two steps of 100 us. fr.score over 5-95 and 105-185; fr.h2d over
    10-40 (pageable, 1000 B) and 110-130 (pinned, 500 B); a copy busy over
    20-30 and a kernel over 35-60; in step 2 a kernel over 125-150. Idle
    under fr.h2d: 10-20 and 30-35 in step 1 (15 us), 110-125 in step 2
    (15 us)."""
    ev = [_span("pb.step", 0, 100), _span("pb.step", 100, 100),
          _span("fr.score", 5, 90), _span("fr.score", 105, 80),
          _span("fr.h2d:1000:1", 10, 30), _span("fr.h2d:500:0", 110, 20),
          # a span that starts before the window is not read
          _span("fr.h2d:7000:1", -50, 20)]
    return _device(ev, [("Memcpy HtoD", 12, 20, 10), ("conv", 33, 35, 25),
                        ("conv", 112, 125, 25)])


def test_idle_under_a_span_that_partly_overlaps_device_events():
    run = _run(_feed_trace())
    assert program_spans.idle_ms_under(run.trace, "fr.h2d") == pytest.approx(0.015)
    assert harness.metric_module("feed_idle_ms.fr_host").read(run) == pytest.approx(0.015)
    # the whole idle time of the window, under a span that covers it
    whole = program_spans.idle_ms_under(run.trace, "pb.step")
    assert whole == pytest.approx((200 - 60) / 1e3 / 2)


@pytest.mark.parametrize("flags,want", [((1, 0), 1000), ((1, 1), 1500), ((0, 0), 0)])
def test_pageable_bytes_read_from_the_span_arguments(flags, want):
    ev = _feed_trace()
    for e in ev:
        if e["name"] == "fr.h2d:1000:1":
            e["name"] = f"fr.h2d:1000:{flags[0]}"
        elif e["name"] == "fr.h2d:500:0":
            e["name"] = f"fr.h2d:500:{flags[1]}"
    run = _run(ev)
    got = harness.metric_module("pageable_mb.fr_host").read(run)
    assert got == pytest.approx(want / 2 / 1e6)


def test_host_time_inside_a_span_a_step():
    run = _run(_feed_trace())
    assert harness.metric_module("dispatch_ms.fr_host").read(run) == pytest.approx(0.085)


@pytest.mark.parametrize("fam", ["nr", "train"])
def test_uploads_counted_per_profiled_step(fam):
    ev = [_span("pb.step", 0, 100), _span("pb.step", 100, 100), _span("pb.step", 200, 100)]
    ev += [_span("ops.upload:196", 10 + 10 * k, 5) for k in range(9)]
    ev += [_span("ops.upload:196", 110 + 10 * k, 5) for k in range(6)]
    # a kernel during the third upload of step 1: 4 us of its 5 busy
    _device(ev, [("mm", 29, 30, 4)])
    run = _run(ev)
    assert harness.metric_module(f"uploads.{fam}").read(run) == pytest.approx(5.0)
    # 15 uploads of 5 us, 4 of them busy, over 3 steps
    assert harness.metric_module(f"upload_idle_ms.{fam}").read(run) == pytest.approx(
        (15 * 5 - 4) / 1e3 / 3)


NEW = ["dispatch_ms.fr_host", "pageable_mb.fr_host", "feed_idle_ms.fr_host", "uploads.nr",
       "upload_idle_ms.nr", "uploads.train", "upload_idle_ms.train", "jbu_roofline.train",
       "channelnorm_roofline.train", "cn_bwd_roofline.train"]


@pytest.mark.parametrize("metric", NEW)
def test_nothing_read_without_the_program_spans(metric):
    # a program without the spans: only the benchmark's own hooks
    ev = [_span("pb.step", 0, 100), _span("pb.jbu:1:8:8:384:4", 10, 20),
          _span("pb.cn:64:448:1:2", 40, 5)]
    _device(ev, [("jbu_kernel", 12, 15, 10), ("channel_norm_kernel", 41, 45, 3)])
    assert harness.metric_module(metric).read(_run(ev)) is None
    assert harness.metric_module(metric).read(Run(cell="x", seconds=1.0, entry=_Entry())) \
        is None


def test_training_rooflines_from_the_program_spans():
    ev = [_span("pb.step", 0, 200),
          _span("nr.jbu:4:32:32:384:4", 10, 20),
          _span("nr.cn:4096:448:1:2", 40, 5),
          # autograd's thread opens the backward's span
          _span("nr.cn_bwd:4096:448:1:2", 100, 10, tid=2)]
    _device(ev, [("jbu_kernel<float>", 12, 15, 10), ("channel_norm_kernel<bf16>", 41, 45, 3),
                 ("channel_norm_bwd_kernel<bf16, 4>", 101, 120, 6),
                 ("channel_norm_bwd_finalize", 102, 126, 2),
                 ("channel_norm_bwd_kernel<bf16, 4>", 150, 160, 6)])  # outside any span
    run = _run(ev)
    read = lambda m: harness.metric_module(m).read(run)  # noqa: E731
    assert read("jbu_roofline.train") == pytest.approx(
        100 * traces.jbu_bound((4, 32, 32, 384), 4) / 10e-6)
    assert read("channelnorm_roofline.train") == pytest.approx(
        100 * traces.cn_bound(4096, 448, True, 2) / 3e-6)
    assert read("cn_bwd_roofline.train") == pytest.approx(
        100 * program_spans.cn_bwd_bound(4096, 448, True, 2) / 8e-6)


def test_cn_bwd_bound_matches_chip_smoke():
    sys.path.insert(0, str(harness.REPO))
    import chip_smoke

    for args in [(4 * 256 * 256, 448, True, 2), (4 * 16 * 16, 896, False, 4),
                 (4 * 128 * 128, 512, True, 2)]:
        assert program_spans.cn_bwd_bound(*args) * 1e3 == pytest.approx(
            chip_smoke.cn_bwd_bound(*args)[0])


def test_interval_helpers():
    assert program_spans.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert program_spans.overlap([(0, 3), (5, 6)], [(2, 5.5)]) == pytest.approx(1.5)
    assert program_spans.overlap([], [(0, 1)]) == 0.0
