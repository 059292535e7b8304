"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere. Run them on the
card with (tests/conftest.py imports JAX, which the card's machine need not
have):  python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""
import pytest
import torch

from nerf_qa_torch.ops.cuda import moments

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
