"""The benchmark's ``adists`` configuration on the CPU: the plain reference
(``portbench/reference/adists.py``) against the port's ``adists_batch`` in
fp32, both cells run by the harness at small sizes, the fp8 control and a
planted fault failing the check, the ADISTS spans of one forward with their
integers, and the T/S bound against ``chip_smoke.tsd_bound``."""
from __future__ import annotations

import json
import time
from collections import Counter

import pytest
import torch

from nerf_qa_torch.config import ADISTSConfig
from nerf_qa_torch.core import adists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.tools import score
from portbench import harness

SEED = 12_345_678_901
# stages 96×128, 96×128, 48×64 and 24×32 fit the 21×21 window; 12×16 and
# 6×8 take the global branch
HW = (96, 128)
WINDOWED = 4
SMALL = {"adists-256-b16": {"batch": 2, "frame_hw": [64, 96], "pool_batches": 2,
                            "reference_block": 2},
         "adists-1080-b8": {"batch": 2, "frame_hw": list(HW), "pool_batches": 1,
                            "reference_block": 1}}
# both sides in fp32; the port windows with two band matmuls and the
# reference with one 21×21 convolution, so their sums round in another
# order (gaps of ~2e-7 here); the bf16 pyramid moves scores by ~1e-7 and
# its fp8 control by ~1e-2
FP32_ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    spec, code = harness.config_files("adists")
    gen = torch.Generator().manual_seed(3)
    state = code.vgg_state(gen, "cpu")
    vgg = VGG16Pyramid()
    vgg.load_state_dict(state)
    ref = torch.rand((3, *HW, 3), generator=gen)
    dist = (ref + (2 * torch.rand(ref.shape, generator=gen) - 1) * 16 / 255).clamp(0, 1)
    return state, vgg, dist.numpy(), ref.numpy()


def _reference(state, dist, ref):
    return harness.reference_module("adists").score_frames(
        state, torch.as_tensor(dist), torch.as_tensor(ref), dtype=torch.float32)


@pytest.mark.parametrize("block_pixels", [448 * 448, 500])
def test_reference_matches_the_port_in_fp32(setup, block_pixels, monkeypatch):
    # 500 pixels: every windowed stage takes the channel-blocked γ
    state, vgg, dist, ref = setup
    blocked = []
    gamma_sum = adists.windowed_gamma_sum

    def spy(f, *a):
        blocked.append(f.shape)
        return gamma_sum(f, *a)

    monkeypatch.setattr(adists, "windowed_gamma_sum", spy)
    cfg = ADISTSConfig(compute_dtype="float32", block_pixels_threshold=block_pixels)
    got = score.adists_batch(vgg, dist, ref, cfg)
    assert len(blocked) == (WINDOWED if block_pixels == 500 else 0)
    want = _reference(state, dist, ref)
    assert float((got - want).abs().max()) <= FP32_ATOL


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_reference_window_over_zeros_is_zero(device):
    # γ = var / (mean + 1e-12) divides by about zero where a window's mean
    # is not exactly 0 over a dead region (cuDNN's implicit GEMM gave
    # ±3e-8 there at 1080p's 135 × 240 level)
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuDNN's algorithms are the card's)")
    ref = harness.reference_module("adists")
    shape = (2, 512, 135, 240) if device == "cuda" else (1, 16, 48, 64)
    gen = torch.Generator(device=device).manual_seed(0)
    f = torch.rand(shape, generator=gen, device=device)
    f[:, 3] = 0
    f[:, 5, :30, :40] = 0
    with torch.no_grad():
        m = ref.wmean(f)
        gamma = (ref.wmean(f * f) - m ** 2) / (m + ref.C0)
    assert torch.all(m[:, 3] == 0) and torch.all(m[:, 5, :10, :20] == 0)
    assert torch.isfinite(gamma).all()


def test_spans_change_no_score(setup):
    _, vgg, dist, ref = setup
    cfg = ADISTSConfig(compute_dtype="float32")
    off = score.adists_batch(vgg, dist, ref, cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = score.adists_batch(vgg, dist, ref, cfg)
    assert torch.equal(off, on)


def _user_spans(fn, tmp_path) -> list[tuple[str, list[int], float, float]]:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = []
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            name, *ints = e["name"].split(":")
            out.append((name, [int(v) for v in ints], e["ts"], e["ts"] + e["dur"]))
    return out


def test_forward_opens_every_adists_span(setup, tmp_path):
    _, vgg, dist, ref = setup
    spans = _user_spans(lambda: score.adists_batch(
        vgg, dist, ref, ADISTSConfig(compute_dtype="float32")), tmp_path)
    counts = Counter(name for name, *_ in spans)
    n = dist.shape[0]
    # stage shapes, coarse to fine, as the cascade visits them
    shapes = [(n, 6, 8, 512), (n, 12, 16, 512), (n, 24, 32, 256), (n, 48, 64, 128),
              (n, *HW, 64), (n, *HW, 3)]
    assert counts["adists.forward"] == counts["adists.weights"] == counts["dists.vgg"] == 1
    assert counts["adists.norms"] == 6
    assert counts["adists.tsd"] == WINDOWED
    assert counts["adists.global"] == 6 - WINDOWED
    assert [ints for name, ints, *_ in spans if name == "adists.ps"] == [list(s) for s in shapes]
    assert [ints for name, ints, *_ in spans if name == "adists.tsd"] == \
        [[*s, 4] for s in shapes[6 - WINDOWED:]]
    (fwd,) = [s for s in spans if s[0] == "adists.forward"]
    assert all(fwd[2] <= s[2] and s[3] <= fwd[3] for s in spans if s[0] != "adists.forward")
    globals_ = [s for s in spans if s[0] == "adists.global"]
    for name, ints, a, b in spans:  # the global stages hold their ps step
        if name == "adists.ps" and len(ints) and ints[1] < 21:
            assert any(g[2] <= a and b <= g[3] for g in globals_)


def _run_cpu(cell):
    return harness.run_cell(cell, SEED, 0.2, False, time.perf_counter(), "cpu",
                            SMALL[cell])[0]


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    result = _run_cpu(cell)
    assert result["correct"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_the_limit(cell):
    entry = harness.make_entry(cell, 777, "cpu", SMALL[cell])
    assert any(c["value"] > c["limit"] for c in entry.control())


@pytest.mark.parametrize("cell", list(SMALL))
def test_planted_fault_is_not_correct(cell, monkeypatch):
    batch = score.adists_batch

    def altered(*a, **k):
        out = batch(*a, **k).clone()
        out[0] += 1e-2
        return out

    monkeypatch.setattr(score, "adists_batch", altered)
    assert not _run_cpu(cell)["correct"]


@pytest.mark.parametrize("hw,batch", [((256, 256), 16), ((1080, 1920), 8)])
def test_tsd_bound_is_chip_smokes(hw, batch):
    import chip_smoke

    spec, code = harness.config_files("adists")
    dists_code = harness.load_module(harness.HERE / "configs" / "dists.py")
    sizes = dists_code.stage_sizes(spec, *hw)
    levels = [(batch, h, w, c) for (h, w), c in
              zip([sizes[0], *sizes], spec["pyramid_channels"]) if h >= 21 and w >= 21]
    assert len(levels) == (5 if hw == (256, 256) else 6)
    for shape in levels:
        for itemsize in (2, 4):
            ms, _ = chip_smoke.tsd_bound(shape, itemsize)
            assert code.tsd_bound(shape, itemsize) == pytest.approx(ms / 1e3, rel=1e-12)
