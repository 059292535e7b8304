"""The metric arithmetic on hand-made inputs: rates, the p95, idle share,
span attribution, rooflines, and the configurations' FLOP counts."""
import json
import math
import sys
from types import SimpleNamespace

import pytest

from portbench import harness, traces
from portbench.harness import Run


class _Entry:
    frames_per_step = 4
    flops_per_step = 1e12
    ctx = SimpleNamespace(traffic={"clip_batches": 2})


def _run(step_s, window_s=None, trace=None):
    r = Run(cell="x", seconds=1.0, entry=_Entry(), step_s=list(step_s), trace=trace)
    r.steps = len(step_s)
    r.frames = r.steps * 4
    r.window_s = sum(step_s) if window_s is None else window_s
    return r


@pytest.mark.parametrize("metric", ["fr_pairs_per_s", "fr_host_pairs_per_s", "nr_frames_per_s",
                                    "train_frames_per_s"])
def test_rate_is_all_work_over_all_time(metric):
    read = harness.metric_module(metric).read
    assert read(_run([0.1] * 10)) == pytest.approx(40.0)
    # a window longer than its steps (time between them) counts in full
    assert read(_run([0.1] * 10, window_s=2.0)) == pytest.approx(20.0)


@pytest.mark.parametrize("metric", ["fr_clip_ms_p95", "nr_clip_ms_p95"])
def test_p95_moves_when_one_stall_is_planted(metric):
    # clips of two batches: five clips of 0.2 s, then the last one stalled
    read = harness.metric_module(metric).read
    base = [0.1] * 10
    stalled = base[:-2] + [0.1, 0.9]
    assert read(_run(base)) == pytest.approx(200.0)
    assert read(_run(stalled)) > 260.0
    # a step left over after the last whole clip is not a clip
    assert read(_run(base + [5.0])) == pytest.approx(200.0)


def _chrome():
    """Two steps of 100 us; kernels A (10-30, launched at 5), B (50-60,
    launched in pb.vgg at 45) and C (120-170, launched at 115 in pb.cn)."""
    ev = [
        {"cat": "user_annotation", "name": "pb.step", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "pb.step", "ts": 100, "dur": 100},
        {"cat": "user_annotation", "name": "pb.vgg", "ts": 40, "dur": 20},
        {"cat": "user_annotation", "name": "pb.cn:1000:64:1:2", "ts": 110, "dur": 10},
    ]
    for corr, (name, launch, start, dur) in enumerate(
            [("A", 5, 10, 20), ("B", 45, 50, 10), ("channel_norm_kernel<bf16>", 115, 120, 50)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": corr}})
    return ev


def test_idle_share_and_attribution_on_a_hand_made_trace():
    t = traces.Trace.from_chrome(_chrome())
    assert t.window() == (0.0, 200.0) and t.steps() == 2
    assert t.busy_us() == pytest.approx(80.0)
    assert t.idle_share() == pytest.approx(0.6)
    assert t.device_us_in("pb.vgg") == pytest.approx(10.0)
    assert t.device_us_in("pb.cn") == pytest.approx(50.0)
    assert t.device_us_in("pb.decoder") is None
    run = _run([1e-4, 1e-4], trace=t)
    for fam in ("fr", "fr_host", "nr"):
        assert harness.metric_module(f"device_idle_share.{fam}").read(run) == \
            pytest.approx(60.0)
        assert harness.metric_module(f"vgg_ms.{fam}").read(run) == pytest.approx(0.005)
        # MFU: 2 steps of 1e12 FLOPs in 200 us
        assert harness.metric_module(f"mfu.{fam}").read(run) == pytest.approx(
            100 * 2e12 / 200e-6 / traces.PEAK_BF16_FLOPS)
    share = harness.metric_module("channelnorm_roofline.nr").read(run)
    assert share == pytest.approx(100 * traces.cn_bound(1000, 64, True, 2) / 50e-6)
    assert harness.metric_module("jbu_roofline.nr").read(run) is None
    # no copy from the host in this trace: nothing to read
    assert harness.metric_module("h2d_ms.fr_host").read(run) is None
    assert t.top_device_ops(2)[0][0].startswith("channel_norm_kernel")
    assert sum(s for _, s in t.idle_gaps()) == pytest.approx(120e-6)


def test_h2d_reads_only_the_copies_from_the_host():
    ev = [{"cat": "user_annotation", "name": "pb.step", "ts": 0, "dur": 100}]
    for corr, (cat, name, launch, start, dur) in enumerate([
            ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2, 3, 30),
            ("kernel", "conv", 40, 41, 40),
            ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 90, 2)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"cat": cat, "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": corr}})
    run = _run([1e-4], trace=traces.Trace.from_chrome(ev))
    assert harness.metric_module("h2d_ms.fr_host").read(run) == pytest.approx(0.030)


def test_union_and_gaps():
    assert traces.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert traces.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert traces.percentile([1, 2, 3, 4, 5], 50) == 3
    assert traces.percentile(list(range(101)), 95) == 95


def test_vgg16_count_at_256_is_20_04_gmac():
    spec, code = harness.config_files("dists")
    assert code.vgg_macs(spec, 256, 256) == 20_044_578_816
    assert code.pair_flops(spec, 1080, 1920) / 1e12 == pytest.approx(2.5386, abs=1e-4)


def test_nr_counts():
    spec, code = harness.config_files("nr-v8")
    assert code.decoder_macs(spec, 256) / 1e9 == pytest.approx(700.70, abs=0.01)
    assert code.score_flops(spec, 256, 224) / 1e12 == pytest.approx(1.4799, abs=1e-4)
    assert 4 * code.train_flops(spec, 256, 224) / 1e12 == pytest.approx(17.291, abs=1e-3)


def test_frozen_bounds_match_chip_smoke():
    sys.path.insert(0, str(harness.REPO))
    import chip_smoke

    assert traces.moments_bound((128, 64, 64, 256), 2) * 1e3 == pytest.approx(
        chip_smoke.moments_bound((128, 64, 64, 256), 2)[0])
    assert traces.jbu_bound((8, 128, 128, 384), 4) * 1e3 == pytest.approx(
        chip_smoke.jbu_bound((8, 128, 128, 384), 4)[0])
    assert traces.cn_bound(4 * 256 * 256, 448, True, 2) * 1e3 == pytest.approx(
        chip_smoke.cn_bound(4 * 256 * 256, 448, True, 2)[0])
