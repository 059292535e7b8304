"""The sub-pixel form of the NR decoders' 2x transposed conv
(nerf_qa_torch/ops/subpixel.py) against torch's transposed conv and the
JAX package's conv_transpose_2x_subpixel, on the CPU: the same numpy
inputs, weights carried across as the weight bridge carries them (HWIO
flipped), fp32 to 1e-5; its bf16 gradient; the module's state_dict
interchangeable with the transposed conv's; the environment variable that
picks the form."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_qa_torch.models.nr import layers as tlayers
from nerf_qa_torch.ops import subpixel
from nerf_qa_tpu.ops.subpixel import conv_transpose_2x_subpixel as jax_subpixel
from tests.torch_parity import one_torch_thread  # noqa: F401

# (N, I, O, H, W): square and odd sizes, and a decoder-like width
SHAPES = [(2, 5, 4, 6, 7), (1, 3, 8, 1, 1), (2, 24, 16, 9, 5), (1, 387, 64, 4, 4)]


def _case(n, i, o, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, i)).astype(np.float32)  # NHWC
    k = (rng.standard_normal((3, 3, i, o)) / np.sqrt(9 * i)).astype(np.float32)  # flax HWIO
    b = rng.standard_normal(o).astype(np.float32)
    # torch's transposed conv correlates with the flipped kernel
    # (compat/from_jax._conv_transpose)
    w_t = np.ascontiguousarray(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    return x, k, b, w_t


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_subpixel_matches_conv_transpose2d(shape):
    # fp32: the same products summed in another order, atol 1e-5
    x, _, b, w = _case(*shape)
    want = F.conv_transpose2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b),
                              stride=2, padding=1, output_padding=1)
    got = subpixel.conv_transpose_2x_subpixel(_nchw(x), torch.from_numpy(w),
                                              torch.from_numpy(b))
    assert got.shape == want.shape == (shape[0], shape[2], 2 * shape[3], 2 * shape[4])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_subpixel_matches_jax(shape):
    # the JAX package's sub-pixel form on the flax kernel, fp32 atol 1e-5
    x, k, b, w = _case(*shape, seed=1)
    want = np.asarray(jax_subpixel(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    for fn in (subpixel.conv_transpose_2x_subpixel, subpixel.conv_transpose_2x_dense):
        got = fn(_nchw(x), torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_subpixel_bf16_gradient():
    # the bf16 form differentiates (the JAX form once raised there,
    # tests/test_nr_versions.py) and its gradients are the transposed
    # conv's to bf16 rounding: 2**-6 of the largest fp32 gradient
    x, _, b, w = _case(2, 24, 16, 9, 5, seed=2)
    g = np.random.default_rng(3).standard_normal((2, 16, 18, 10)).astype(np.float32)
    grads = {}
    for name, fn, dt in (("sub", subpixel.conv_transpose_2x_subpixel, torch.bfloat16),
                         ("ref", subpixel.conv_transpose_2x_dense, torch.float32)):
        xx = _nchw(x).to(dt).requires_grad_(True)
        ww = torch.from_numpy(w).requires_grad_(True)
        bb = torch.from_numpy(b).requires_grad_(True)
        out = fn(xx, ww.to(dt), bb)
        assert out.dtype == dt
        out.float().backward(torch.from_numpy(g))
        grads[name] = (xx.grad.float(), ww.grad, bb.grad)
    for got, want in zip(grads["sub"], grads["ref"]):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 2**-6 * float(want.abs().max())


def test_state_dicts_interchange():
    # SubpixelConvTranspose has nn.ConvTranspose2d's keys and shapes: each
    # loads the other's weights, strict, and they compute the same map
    sub = tlayers.SubpixelConvTranspose(6, 5)
    dense = torch.nn.ConvTranspose2d(6, 5, 3, stride=2, padding=1, output_padding=1)
    assert sub.state_dict().keys() == dense.state_dict().keys()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in sub.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    dense.load_state_dict(sub.state_dict(), strict=True)
    x = torch.randn((2, 6, 4, 3), generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(sub(x), dense(x), rtol=0, atol=1e-5)
        sub.load_state_dict(dense.state_dict(), strict=True)
        torch.testing.assert_close(sub(x), dense(x), rtol=0, atol=1e-5)


def test_environment_variable_picks_the_form(monkeypatch):
    # unset: the transposed conv on CPU tensors (the JAX package's default)
    x, _, b, w = _case(1, 8, 4, 5, 6, seed=4)
    layer = tlayers.ConvTransposeLayer(8, 4)
    xx = _nchw(x)
    monkeypatch.delenv(subpixel.ENV, raising=False)
    assert not subpixel.subpixel_enabled(xx)
    with torch.no_grad():
        plain = layer(xx)
    monkeypatch.setenv(subpixel.ENV, "1")
    assert subpixel.subpixel_enabled(xx)
    with torch.no_grad():
        sub = layer(xx)
    torch.testing.assert_close(sub, plain, rtol=0, atol=1e-5)
    monkeypatch.setenv(subpixel.ENV, "0")
    assert not subpixel.subpixel_enabled(xx)
