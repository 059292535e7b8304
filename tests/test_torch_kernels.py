"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere. Run them on the
card with (tests/conftest.py imports JAX, which the card's machine need not
have):  python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""
import pytest
import torch

from nerf_qa_torch.ops.cuda import channelnorm, jbu, moments

pytestmark = pytest.mark.cuda

# fp32 sums taken in other orders over up to 2M terms
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


def _pair(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    fx = torch.rand(shape, generator=g, device="cuda")
    fy = 0.6 * fx + 0.4 * torch.rand(shape, generator=g, device="cuda")
    return fx.to(dtype), fy.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (4, 256, 256, 3), (4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256),
    (4, 32, 32, 512), (4, 16, 16, 512), (1, 17, 33, 3), (2, 67, 120, 512),
    (3, 1, 1, 8), (2, 5, 7, 12),
])
def test_moments_kernel_matches_plain(shape, dtype):
    fx, fy = _pair(shape, dtype)
    before = moments.launches
    got = moments.moment_sums(fx, fy)
    torch.cuda.synchronize()
    assert moments.launches == before + 1
    torch.testing.assert_close(got, moments.moment_sums_plain(fx, fy),
                               rtol=RTOL, atol=ATOL)


def test_moments_kernel_unaligned_input_takes_scalar_loads():
    base = torch.rand(1 + 2 * 9 * 11 * 64, device="cuda")
    fx = base[1:].view(2, 9, 11, 64)  # 4-byte offset: not 16-byte aligned
    fy = torch.flip(fx, dims=(0,)).contiguous()
    torch.testing.assert_close(moments.moment_sums(fx, fy),
                               moments.moment_sums_plain(fx, fy),
                               rtol=RTOL, atol=ATOL)


def test_moments_kernel_repeats_bit_for_bit():
    fx, fy = _pair((2, 200, 300, 64), torch.bfloat16)
    assert torch.equal(moments.moment_sums(fx, fy), moments.moment_sums(fx, fy))


def test_moments_stats_match_two_pass_at_1080p():
    fx, fy = _pair((2, 1080, 1920, 64), torch.bfloat16)
    got = moments.stage_stats_kernel(fx, fy)
    x, y = fx.double(), fy.double()
    mx, my = x.mean((1, 2)), y.mean((1, 2))
    dx, dy = x - mx[:, None, None], y - my[:, None, None]
    want = (mx, my, dx.square().mean((1, 2)), dy.square().mean((1, 2)),
            (dx * dy).mean((1, 2)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=RTOL, atol=ATOL)


def test_moments_kernel_rejects_grad_and_bad_layout():
    fx, fy = _pair((1, 8, 8, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        moments.moment_sums(fx.requires_grad_(True), fy)
    with pytest.raises(ValueError):
        moments.moment_sums(fy.transpose(1, 2), fy.transpose(1, 2))


# ChannelNorm: fp32 row statistics in other orders; bf16 output may round
# the other way once (one bf16 ulp, 2**-8 relative)
CN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rows,c", [(1000, 384), (777, 387), (513, 448),
                                    (300, 512), (257, 640), (129, 896),
                                    (33, 3), (5, 1024)])
def test_channelnorm_kernel_matches_plain(rows, c, gelu, dtype):
    g = torch.Generator(device="cuda").manual_seed(c)
    x = (1.5 * torch.randn((rows, c), generator=g, device="cuda") + 0.3).to(dtype)
    scale = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.2 * torch.randn(c, generator=g, device="cuda")
    before = channelnorm.launches
    got = channelnorm.channel_norm_act(x, scale, bias, gelu=gelu)
    torch.cuda.synchronize()
    assert channelnorm.launches == before + 1 and got.dtype == dtype
    rtol, atol = CN_TOL[dtype]
    torch.testing.assert_close(
        got.float(), channelnorm.channel_norm_act_plain(x, scale, bias, gelu=gelu).float(),
        rtol=rtol, atol=atol)


def test_channelnorm_kernel_unaligned_and_nhwc_view():
    base = torch.randn(1 + 6 * 5 * 448, device="cuda")
    x = base[1:].view(6, 5, 448)  # 4-byte offset: scalar loads
    s, b = torch.ones(448, device="cuda"), torch.zeros(448, device="cuda")
    torch.testing.assert_close(channelnorm.channel_norm_act(x, s, b, gelu=True),
                               channelnorm.channel_norm_act_plain(x, s, b, gelu=True),
                               rtol=1e-5, atol=1e-5)


def test_channelnorm_module_routes_cuda_tensors_to_the_kernel():
    from nerf_qa_torch.models.nr.layers import ChannelNorm, nchw

    cn = ChannelNorm(387).cuda()
    x = nchw(torch.randn(2, 9, 11, 387, device="cuda"))
    before = channelnorm.launches
    with torch.no_grad():
        got = cn(x, gelu=True)
        assert channelnorm.launches == before + 1
        cn.fused = False
        want = cn(x, gelu=True)
    assert channelnorm.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_channelnorm_kernel_rejects_grad_layout_and_width():
    x = torch.randn(4, 8, 64, device="cuda")
    s, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        channelnorm.channel_norm_act(x.clone().requires_grad_(True), s, b)
    with pytest.raises(ValueError):
        channelnorm.channel_norm_act(x.transpose(0, 1), s, b)
    wide = torch.randn(2, 1100, device="cuda")
    with pytest.raises(ValueError):
        channelnorm.channel_norm_act(wide, torch.ones(1100, device="cuda"),
                                     torch.zeros(1100, device="cuda"))


def _jbu_inputs(shape, dtype, seed=0):
    n, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    hr = torch.randn(shape, generator=g, device="cuda").to(dtype)
    proj = (0.3 * torch.randn((n, h, w, 32), generator=g, device="cuda")).to(dtype)
    offs = torch.linspace(-1, 1, 7, device="cuda")
    sq = (offs[:, None] ** 2 + offs[None, :] ** 2).reshape(-1)
    spatial = torch.exp(-sq / (2 * 0.9**2))
    return hr, proj, spatial, torch.tensor(1.7, device="cuda")


# fp32 accumulation of 49 terms and 32-term dots in other orders
JBU_RTOL, JBU_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 32, 384), (1, 64, 48, 384),
                                   (1, 17, 33, 48), (3, 4, 5, 8), (1, 16, 16, 33)])
def test_jbu_kernel_matches_plain(shape, dtype):
    hr, proj, spatial, temp = _jbu_inputs(shape, dtype)
    before = jbu.launches
    got = jbu.jbu_filter(hr, proj, spatial, temp)
    torch.cuda.synchronize()
    assert jbu.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, jbu.jbu_filter_plain(hr, proj, spatial, temp),
                               rtol=JBU_RTOL, atol=JBU_ATOL)


def test_jbu_module_routes_cuda_tensors_to_the_kernel():
    from nerf_qa_torch.models.nr.featup import JBU

    up = JBU(48).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn((2, 8, 11, 48), generator=g, device="cuda")
    guide = torch.rand((2, 16, 22, 3), generator=g, device="cuda")
    before = jbu.launches
    with torch.no_grad():
        got = up(src, guide)
        assert jbu.launches == before + 1
        up.fused = False
        want = up(src, guide)
    assert jbu.launches == before + 1
    torch.testing.assert_close(got, want, rtol=JBU_RTOL, atol=JBU_ATOL)


def test_jbu_kernel_rejects_grad_and_bad_shapes():
    hr, proj, spatial, temp = _jbu_inputs((1, 8, 8, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        jbu.jbu_filter(hr.clone().requires_grad_(True), proj, spatial, temp)
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr, proj[..., :16].contiguous(), spatial, temp)  # K != 32
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr[:, :3, :3].contiguous(), proj[:, :3, :3].contiguous(),
                       spatial, temp)  # H, W <= radius
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr.transpose(1, 2), proj.transpose(1, 2), spatial, temp)
