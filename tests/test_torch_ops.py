"""The port's ops (resize, L2 pool, VGG pyramid, moments plain version)
against the JAX package, on the CPU, with inputs made by numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.core import vgg as tvgg
from nerf_qa_torch.ops import l2pool as tl2pool
from nerf_qa_torch.ops import resize as tresize
from nerf_qa_torch.ops.cuda import moments as tmoments
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.core import vgg as jvgg
from nerf_qa_tpu.ops import l2pool as jl2pool
from nerf_qa_tpu.ops import resize as jresize
from nerf_qa_tpu.ops.pallas.moments import stage_stats_pallas
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (64, 64)),
                                          ((128, 96), (64, 48)),
                                          ((64, 80), (64, 33))])
def test_resize_fp32_matches_jax(align_corners, in_hw, out_hw):
    # fp32 matmul form on both sides: rtol 1e-5, atol 1e-6
    x = np.random.default_rng(3).random((2, *in_hw, 3), dtype=np.float32)
    want = np.asarray(jresize.resize_bilinear(
        jnp.asarray(x), *out_hw, align_corners=align_corners))
    got = tresize.resize_bilinear(torch.from_numpy(x), *out_hw,
                                  align_corners=align_corners)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_resize_matrix_matches_jax():
    for args in [(37, 64, False), (100, 7, True), (5, 5, False), (1, 4, True)]:
        np.testing.assert_array_equal(tresize._resize_matrix(*args),
                                      jresize._resize_matrix(*args))


def test_resize_bf16_uint8_fast_path_matches_jax():
    # serving path: uint8 input, bf16 matrices with 1/255 folded in. atol
    # 1e-2 covers bf16 rounding of the matrix and of the intermediate.
    u8 = np.random.default_rng(4).integers(0, 256, (2, 90, 120, 3), dtype=np.uint8)
    want = np.asarray(jresize.resize_bilinear(
        jnp.asarray(u8), 64, 64, precision=jax.lax.Precision.DEFAULT,
        compute_dtype=jnp.bfloat16, scale=1 / 255))
    got = tresize.resize_bilinear(torch.from_numpy(u8), 64, 64,
                                  compute_dtype=torch.bfloat16, scale=1 / 255)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)


def test_resize_scale_without_resize():
    x = np.random.default_rng(5).random((1, 8, 8, 3), dtype=np.float32)
    got = tresize.resize_bilinear(torch.from_numpy(x), 8, 8, scale=0.5)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), 8, 8, scale=0.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("hw", [(1080, 1920), (1920, 1080), (256, 256), (7, 3)])
def test_shortest_side_target(hw):
    assert tresize.shortest_side_target(*hw) == jresize.shortest_side_target(*hw)


@pytest.mark.parametrize("shape", [(2, 64, 96, 3), (1, 63, 97, 4),
                                   (1, 320, 330, 2)])
def test_l2pool_matches_jax(shape):
    # (1, 320, 330, 2) is above 100k pixels, where JAX takes its band
    # branch; the port has one conv formulation. rtol 1e-5, atol 1e-6.
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    want = np.asarray(jl2pool.l2pool(jnp.asarray(x)))
    got = tl2pool.l2pool(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_hann_filter_is_the_reference_buffer():
    np.testing.assert_array_equal(tl2pool.hann_kernel(5), jl2pool._hann_kernel(5))
    filt = tl2pool.hann_filter(64)
    assert tuple(filt.shape) == (64, 1, 3, 3)
    np.testing.assert_allclose(filt.sum((1, 2, 3)).numpy(), 1.0, rtol=1e-6)


def test_normalize_imagenet_matches_jax():
    x = np.random.default_rng(2).random((2, 5, 6, 3), dtype=np.float32)
    np.testing.assert_allclose(
        tvgg.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(jvgg.normalize_imagenet(jnp.asarray(x))), rtol=1e-6)


def test_pyramid_fp32_matches_jax(jax_params, torch_model):
    # rtol 2e-4, atol 2e-5: the JAX package's own torch-oracle tolerance
    # (tests/test_dists_parity.py:90-91)
    x = np.random.default_rng(42).random((2, 64, 96, 3), dtype=np.float32)
    want = jvgg.vgg16_pyramid(jax_params, jnp.asarray(x))
    got = tvgg.vgg16_pyramid(torch_model, torch.from_numpy(x))
    assert len(got) == 6
    for k, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, f"stage {k}"
        assert g.is_contiguous(), f"stage {k} is not contiguous NHWC"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=f"stage {k}")


def test_pyramid_bf16_features_are_channels_last(torch_model):
    x = torch.from_numpy(
        np.random.default_rng(7).random((1, 32, 48, 3), dtype=np.float32))
    feats = torch_model(x, torch.bfloat16)
    for f, c in zip(feats, tvgg.PYRAMID_CHANNELS):
        assert f.dtype == torch.bfloat16 and f.shape[-1] == c
        assert f.is_contiguous()
        assert f.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("stage_idx", [1, 3])
def test_vgg_stage_apply_matches_jax(jax_params, torch_model, stage_idx):
    cin = tvgg.VGG16_STAGES[stage_idx - 1][0][0]
    x = np.random.default_rng(stage_idx).random((1, 16, 20, cin), dtype=np.float32)
    want = jvgg.vgg_stage_apply(jax_params, stage_idx, jnp.asarray(x))
    got = tvgg.vgg_stage_apply(torch_model, stage_idx, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 32, 48, 64), (1, 17, 33, 3),
                                   (2, 67, 120, 512)])
def test_moment_sums_plain_matches_pallas_and_xla(shape):
    # single-pass stats from the plain sums vs the Pallas kernel (interpret
    # mode off TPU) and the two-pass XLA oracle: rtol 2e-5, atol 1e-6
    rng = np.random.default_rng(1)
    fx = rng.random(shape, dtype=np.float32)
    fy = rng.random(shape, dtype=np.float32)
    got = tmoments.stage_stats_kernel(torch.from_numpy(fx), torch.from_numpy(fy))
    for ref in (stage_stats_pallas(jnp.asarray(fx), jnp.asarray(fy)),
                jdists.stage_stats_xla(jnp.asarray(fx), jnp.asarray(fy))):
        for name, a, b in zip(got._fields, got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=1e-6, err_msg=name)


def test_moments_wrapper_on_cpu_uses_plain_and_counts_nothing():
    fx = torch.rand(2, 5, 7, 8)
    fy = torch.rand(2, 5, 7, 8)
    before = tmoments.launches
    torch.testing.assert_close(tmoments.moment_sums(fx, fy),
                               tmoments.moment_sums_plain(fx, fy))
    assert tmoments.launches == before
    assert tmoments.moment_sums(fx.bfloat16(), fy.bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("bad", ["grad", "dtype", "shape", "layout", "mixed"])
def test_moments_wrapper_rejects(bad):
    fx = torch.rand(2, 5, 7, 8)
    fy = torch.rand(2, 5, 7, 8)
    if bad == "grad":
        fx.requires_grad_(True)
    elif bad == "dtype":
        fx, fy = fx.half(), fy.half()
    elif bad == "shape":
        fy = fy[:, :4]
    elif bad == "layout":
        fx, fy = fx.transpose(1, 2), fy.transpose(1, 2)
    else:
        fy = fy.double()
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        tmoments.moment_sums(fx, fy)


@pytest.mark.parametrize("hw,c,itemsize,aligned", [
    (65536, 3, 2, True), (65536, 64, 2, True), (16384, 128, 4, True),
    (256, 512, 2, True), (561, 3, 4, True), (8040, 512, 4, False),
    (2_073_600, 64, 2, True), (1, 1000, 4, True),
])
def test_launch_config_covers_every_pixel_once(hw, c, itemsize, aligned):
    cfg = tmoments.launch_config(hw, c, itemsize, aligned)
    assert cfg.cgb * cfg.pl <= 256
    assert c % cfg.vec == 0 and cfg.vec * itemsize in (itemsize, 16)
    assert aligned or cfg.vec == 1
    assert cfg.p * cfg.chunk >= hw > (cfg.p - 1) * cfg.chunk
    assert cfg.cgb <= c // cfg.vec
    assert cfg.chunk == cfg.pl * 32
    # shared memory of the tree stays under the 48 KB static limit
    assert 5 * cfg.vec * cfg.cgb * cfg.pl * 4 <= 48 * 1024
