"""The windowed γ sum of ADISTS: the dispatch of
``core/adists.windowed_gamma_sum`` and the benchmark's roofline bound on
the CPU, and the CUDA kernel (``ops/cuda/windowed_gamma.py``) against its
plain version on the card.

The ``cuda`` tests skip without a card. Run them there with (tests/conftest.py
imports JAX, which the card's machine need not have):
  python -m pytest tests/test_torch_windowed_gamma.py -m cuda --noconftest
"""
import pytest
import torch

from nerf_qa_torch.core import adists
from nerf_qa_torch.ops.cuda import windowed_gamma as wg

# fp32 window sums in another order than the plain version's band matmuls
# or depthwise convolutions: the per-channel ratios agree to a few units
# in 1e-7, and their sum over channels has no cancellation
RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")


def _features(shape, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device).to(dtype)


def _assert_close(got, want):
    # RTOL of each value, and 1e-7 of the map's largest (values near 0)
    err = (got.double() - want.double()).abs()
    allowed = RTOL * want.double().abs() + 1e-7 * float(want.abs().max())
    assert bool((err <= allowed).all()), float((err / allowed).max())


# ---- the CPU


def test_cpu_tensors_take_the_plain_loop():
    f = _features((2, 40, 50, 20))
    before = wg.launches
    got = adists.windowed_gamma_sum(f, 21, 16)
    assert wg.launches == before
    assert got.shape == (2, 20, 30, 1) and got.dtype == torch.float32
    assert torch.equal(got, wg.windowed_gamma_sum_plain(f, 21, 16))


def test_grad_requiring_input_takes_the_plain_loop():
    # on a device with no kernel the plain loop runs where autograd records
    # f, and the kernel's wrapper raises where it does not
    f = torch.empty((1, 30, 40, 8), device="meta", requires_grad=True)
    before = wg.launches
    got = adists.windowed_gamma_sum(f, 21, 16)
    assert got.device.type == "meta" and got.shape == (1, 10, 20, 1)
    assert got.requires_grad
    with torch.no_grad(), pytest.raises(ValueError, match="device meta"):
        adists.windowed_gamma_sum(f, 21, 16)
    assert wg.launches == before
    # and on the CPU the gradient flows through it
    x = _features((1, 30, 40, 8)).requires_grad_(True)
    adists.windowed_gamma_sum(x, 21, 4).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_other_devices_raise():
    f = torch.empty((1, 30, 40, 8), device="meta")
    with pytest.raises(ValueError, match="no windowed γ kernel for device meta"):
        adists.windowed_gamma_sum(f, 21, 16)
    with pytest.raises(ValueError, match="device"):
        wg.windowed_gamma_sum(_features((1, 30, 40, 8)))


def test_gamma_bound_by_hand():
    from portbench import harness
    from portbench.traces import DeviceEvent, Span, Trace

    metric = harness.metric_module("gamma_roofline.adists")
    # (2, 41, 61, 3), bf16: Hk = 21, Wk = 41
    n_bytes = 2 * 41 * 61 * 3 * 2 + 2 * 21 * 41 * 4
    assert n_bytes == 36_900
    ops = 2 * 3 * (41 * 61 + 84 * 21 * 61 + 89 * 21 * 41)
    assert ops == 1_120_404
    want = max(36_900 / 3.35e12, 1_120_404 / 67e12)  # operations bound it
    assert want == 1_120_404 / 67e12
    assert metric.gamma_bound((2, 41, 61, 3), 2) == pytest.approx(want, rel=1e-12)
    # the 1080p stage 1 at batch 8: ~180 G operations, ~2.7 ms
    assert metric.gamma_bound((8, 1080, 1920, 64), 2) == pytest.approx(2.69e-3, rel=1e-2)
    import chip_smoke  # its timing rows use the same bound

    for shape in [(2, 41, 61, 3), (8, 1080, 1920, 3), (8, 540, 960, 128)]:
        for itemsize in (2, 4):
            ms, _ = chip_smoke.gamma_bound(shape, itemsize)
            assert metric.gamma_bound(shape, itemsize) == pytest.approx(ms / 1e3, rel=1e-12)

    run = type("Run", (), {})()
    run.trace = Trace()
    assert metric.read(run) is None  # a program without the span
    run.trace = Trace(
        device=[DeviceEvent("void (anonymous namespace)::gamma_kernel<float, false>()",
                            20.0, 0.05, 5.0),
                DeviceEvent("void (anonymous namespace)::other_kernel()", 21.0, 1.0, 6.0)],
        spans=[Span("adists.gamma:2:41:61:3:2", 0.0, 10.0)])
    assert metric.read(run) == pytest.approx(100 * want / 0.05e-6, rel=1e-9)


# ---- the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (2, 60, 150, 3),  # stage 0's channels: plain loads
    (1, 80, 250, 64),  # three column tiles
    (1, 45, 100, 128),  # one column tile
    (2, 50, 70, 12),  # C not a multiple of bf16's 8-channel chunk
    (1, 21, 21, 5),  # the smallest stage
    (1, 21, 300, 16),  # H = 21
    (2, 130, 21, 8),  # W = 21
    (1, 1080, 1920, 3), (1, 1080, 1920, 64), (1, 540, 960, 128),  # 1080p
])
def test_kernel_matches_plain(card, shape, dtype):
    f = _features(shape, dtype, "cuda")
    before = wg.launches
    got = wg.windowed_gamma_sum(f)
    torch.cuda.synchronize()
    assert wg.launches == before + 1
    assert got.shape == (shape[0], shape[1] - 20, shape[2] - 20, 1)
    _assert_close(got, wg.windowed_gamma_sum_plain(f, 21, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_unaligned_view(card, dtype):
    # C = 64 would take 16-byte copies; a view one element past a 16-byte
    # boundary takes the plain-load path
    f = _features((2, 40, 60, 64), dtype, "cuda", seed=5)
    base = torch.empty(f.numel() + 1, dtype=dtype, device="cuda")
    view = base[1:].view(f.shape)
    view.copy_(f)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert not wg._plan(*f.shape, dtype, False).vec
    _assert_close(wg.windowed_gamma_sum(view), wg.windowed_gamma_sum_plain(f, 21, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 68, 120, 512), (2, 135, 240, 512),
                                   (1, 40, 50, 30)])
def test_kernel_channel_groups(card, shape, dtype):
    assert wg._plan(*shape, dtype).groups > 1
    f = _features(shape, dtype, "cuda", seed=3)
    _assert_close(wg.windowed_gamma_sum(f), wg.windowed_gamma_sum_plain(f, 21, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 80, 200, 64), (1, 68, 120, 512)])
def test_kernel_exact_zero_over_dead_windows(card, shape):
    # dead channels and a region dead in every channel: every window inside
    # it sums to exactly 0, so γ is 0 there, as in the plain version
    f = _features(shape, torch.bfloat16, "cuda", seed=7)
    f[..., 3] = 0
    f[..., 10:20] = 0
    f[:, :45, :60] = 0
    got = wg.windowed_gamma_sum(f)
    want = wg.windowed_gamma_sum_plain(f, 21, 16)
    dead = want == 0
    assert bool(dead[:, :25, :40].all())
    assert bool((got[dead] == 0).all())
    assert torch.isfinite(got).all()
    _assert_close(got, want)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(card):
    f = _features((2, 100, 150, 40), torch.bfloat16, "cuda")
    assert torch.equal(wg.windowed_gamma_sum(f), wg.windowed_gamma_sum(f))
    # split channels: the partial maps are added in group order
    f = _features((1, 68, 120, 512), torch.bfloat16, "cuda")
    assert wg._plan(1, 68, 120, 512).groups > 1
    assert torch.equal(wg.windowed_gamma_sum(f), wg.windowed_gamma_sum(f))


@pytest.mark.cuda
def test_kernel_rejects_grad_layout_dtype_and_small_stages(card):
    f = _features((1, 30, 30, 8), torch.float32, "cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        wg.windowed_gamma_sum(f.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="contiguous"):
        wg.windowed_gamma_sum(f.transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        wg.windowed_gamma_sum(f[:, :20].contiguous())
    with pytest.raises(ValueError, match="window"):
        wg.windowed_gamma_sum(f, 11)
    with pytest.raises(TypeError, match="float16"):
        wg.windowed_gamma_sum(f.half())


@pytest.mark.cuda
def test_kernel_attributes_show_no_spills(card):
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    for bf in (0, 1):
        for vec in (0, 1):
            a = build.kernel_attrs(lib.nqt_windowed_gamma_attrs, bf, vec)
            assert a["local_bytes"] == 0, (bf, vec, a)
            assert a["blocks_per_sm"] >= wg.BLOCKS_PER_SM == a["min_blocks_per_sm"], (
                bf, vec, a)


@pytest.mark.cuda
def test_adists_forward_above_the_block_threshold_launches_the_kernel(card):
    from nerf_qa_torch.compat.pretrained import resolve_vgg_params
    from nerf_qa_torch.config import ADISTSConfig

    model = resolve_vgg_params(seed=0).cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((2, 64, 64, 3), generator=g, device="cuda")
    y = (x + 0.1 * torch.rand(x.shape, generator=g, device="cuda")).clamp(0, 1)
    cfg = ADISTSConfig(compute_dtype="bfloat16")
    before = wg.launches
    with torch.no_grad():
        # 64² and 32² stages: above 1000 pixels all three windowed stages
        # take the blocked γ, below the default 448² none does
        got = adists.forward(model, x, y, cfg.replace(block_pixels_threshold=1000),
                             as_loss=False)
        assert wg.launches == before + 3
        want = adists.forward(model, x, y, cfg, as_loss=False)
    assert wg.launches == before + 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
