"""The port's NR ops (bicubic resize, adaptive pooling, ChannelNorm, the JBU
filter, JBU and JBUStack) against the JAX package, on the CPU, with inputs
made by numpy. The CUDA kernels themselves are held to these plain
versions on the card (tests/test_torch_kernels.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_qa_torch.compat.from_jax import jbu_state_dict_from_jax
from nerf_qa_torch.models.nr import featup as tfeatup
from nerf_qa_torch.models.nr import layers as tlayers
from nerf_qa_torch.ops import resize as tresize
from nerf_qa_torch.ops.cuda import channelnorm as tcn
from nerf_qa_torch.ops.cuda import jbu as tjbu
from nerf_qa_tpu.models.nr import featup as jfeatup
from nerf_qa_tpu.models.nr import layers as jlayers
from nerf_qa_tpu.ops import resize as jresize
from nerf_qa_tpu.ops.pallas.jbu import jbu_filter as jbu_filter_pallas
from tests.test_jbu_kernel import _oracle as jbu_dense_oracle
from tests.torch_parity import one_torch_thread  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- resize / pooling --------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [((16, 16), (32, 32)), ((17, 33), (34, 66)),
                                          ((64, 48), (128, 96)), ((9, 7), (4, 5))])
def test_resize_bicubic_matches_jax_and_torch(in_hw, out_hw):
    # fp32 matmul form on both sides: rtol 1e-5, atol 1e-6; the same
    # matrices as the JAX package, and torch's own bicubic to 1e-5
    x = np.random.default_rng(0).normal(size=(2, *in_hw, 5)).astype(np.float32)
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(x), *out_hw))
    got = tresize.resize_bicubic(torch.from_numpy(x), *out_hw)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw,
                        mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tresize._bicubic_matrix(in_hw[0], out_hw[0]),
                                  jresize._bicubic_matrix(in_hw[0], out_hw[0]))


@pytest.mark.parametrize("in_hw,out_hw", [((224, 224), (256, 256)),
                                          ((224, 224), (32, 32)),
                                          ((224, 224), (128, 128)),
                                          ((56, 56), (64, 64)), ((17, 30), (8, 45))])
def test_adaptive_avg_pool_matches_jax_and_torch(in_hw, out_hw):
    # 224 -> 256 upsamples with overlapping floor/ceil bins, as FeatUp's
    # last guidance pool does (featup.py:154): rtol 1e-5, atol 1e-6
    x = np.random.default_rng(1).random((2, *in_hw, 3), dtype=np.float32)
    want = np.asarray(jresize.adaptive_avg_pool(jnp.asarray(x), *out_hw))
    got = tresize.adaptive_avg_pool(torch.from_numpy(x), *out_hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ref = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                out_hw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


# -- ChannelNorm ---------------------------------------------------------------

def _cn_inputs(shape, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, size=shape + (c,)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, c).astype(np.float32)
    bias = rng.normal(0.0, 0.2, c).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("shape,c", [((2, 8, 8), 387), ((5, 7, 9), 448),
                                     ((3, 4, 4), 896), ((300,), 64)])
def test_channel_norm_matches_jax_module(gelu, shape, c):
    # the JAX module path (exact erf GELU), fp32: atol/rtol 1e-5
    x, scale, bias = _cn_inputs(shape, c)
    want = jlayers.ChannelNorm(c).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x), gelu=gelu)
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    for fn in (tcn.channel_norm_act_plain, tcn.channel_norm_act):
        got = fn(*args, gelu=gelu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("gelu", [False, True])
def test_channel_norm_bf16_matches_jax_module(gelu):
    # bf16 in and out, fp32 statistics on both sides: one bf16 rounding
    # of the output apart at most (rtol 2**-7)
    x, scale, bias = _cn_inputs((4, 6, 5), 448, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jlayers.ChannelNorm(448).apply(
        {"params": {"scale": scale, "bias": bias}}, xb, gelu=gelu)
    got = tcn.channel_norm_act(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(scale), torch.from_numpy(bias),
                               gelu=gelu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2**-7, atol=1e-2)


def test_channel_norm_module_opt_in_routes_to_wrapper(monkeypatch):
    # CPU tensors take the plain version whether or not ``fused`` is set
    # (the kernel route is held on the card in tests/test_torch_kernels.py);
    # the module equals the wrapper on the NHWC rows, which a channels_last
    # map gives without a copy
    x, scale, bias = _cn_inputs((2, 5, 7), 387, seed=2)
    cn = tlayers.ChannelNorm(387)
    with torch.no_grad():
        cn.norm.weight.copy_(torch.from_numpy(scale))
        cn.norm.bias.copy_(torch.from_numpy(bias))
    nchw = tlayers.nchw(torch.from_numpy(x))
    assert nchw.permute(0, 2, 3, 1).is_contiguous()
    calls = []
    monkeypatch.setattr(tlayers, "channel_norm_act",
                        lambda *a, **kw: calls.append(1))
    assert cn.fused
    with torch.no_grad():
        fused = cn(nchw, gelu=True)
        cn.fused = False
        plain = cn(nchw, gelu=True)
    assert calls == []
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    want = tcn.channel_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(bias), gelu=True)
    torch.testing.assert_close(tlayers.nhwc(fused), want, rtol=0, atol=0)
    assert fused.is_contiguous(memory_format=torch.channels_last)


def test_channel_norm_wrapper_rejects_grad_and_bad_args():
    x, scale, bias = _cn_inputs((3,), 16)
    x, scale, bias = (torch.from_numpy(a) for a in (x, scale, bias))
    with pytest.raises(RuntimeError, match="no backward"):
        tcn.channel_norm_act(x.requires_grad_(True), scale, bias)
    with torch.no_grad():  # no graph is built: the forward is allowed
        tcn.channel_norm_act(x, scale.requires_grad_(True), bias)
    with pytest.raises(ValueError):
        tcn.channel_norm_act(x.detach(), scale.detach()[:8], bias)
    with pytest.raises(TypeError):
        tcn.channel_norm_act(x.detach().double(), scale.detach(), bias)


# -- JBU filter ----------------------------------------------------------------

def _spatial(sigma=0.9):
    offs = np.linspace(-1.0, 1.0, 7, dtype=np.float32)
    sq = offs[:, None] ** 2 + offs[None, :] ** 2
    return np.exp(-sq.reshape(-1) / (2.0 * sigma**2)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 17, 33, 48), (1, 4, 5, 8)])
def test_jbu_filter_plain_matches_jax_pallas_interpret(shape):
    # against the JAX package's dense numpy oracle at every shape, and its
    # Pallas kernel (interpret mode) where it takes the shape (H % 8 == 0,
    # W % 16 == 0). That kernel casts its inputs to bf16: feed both sides
    # bf16-representable values, so the only gap is fp32 summation order
    # and exp (rtol/atol 1e-5).
    n, h, w, c = shape
    rng = np.random.default_rng(3)
    hr = rng.normal(size=shape).astype(np.float32)
    proj = (rng.normal(size=(n, h, w, 32)) * 0.3).astype(np.float32)
    hr, proj = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in (hr, proj))
    spatial, temp = _spatial(), np.float32(2.0)
    got = tjbu.jbu_filter(torch.from_numpy(hr), torch.from_numpy(proj),
                          torch.from_numpy(spatial), torch.tensor(temp))
    np.testing.assert_allclose(got.numpy(),
                               jbu_dense_oracle(hr, proj, spatial, temp, 3),
                               rtol=1e-5, atol=1e-5)
    if h % 8 == 0 and w % 16 == 0:
        want = jbu_filter_pallas(jnp.asarray(hr), jnp.asarray(proj),
                                 jnp.asarray(spatial), temp, radius=3,
                                 interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # bf16 inputs: the plain version upcasts, so it equals the fp32 call
    got16 = tjbu.jbu_filter_plain(torch.from_numpy(hr).bfloat16(),
                                  torch.from_numpy(proj).bfloat16(),
                                  torch.from_numpy(spatial), torch.tensor(temp))
    torch.testing.assert_close(got16, got, rtol=0, atol=0)


def test_jbu_filter_wrapper_rejects_grad_and_mismatch():
    hr = torch.zeros(1, 8, 8, 4)
    proj = torch.zeros(1, 8, 8, 32)
    sp, tp = torch.ones(49), torch.tensor(1.0)
    with pytest.raises(RuntimeError, match="no backward"):
        tjbu.jbu_filter(hr.requires_grad_(True), proj, sp, tp)
    with pytest.raises(ValueError):
        tjbu.jbu_filter(hr.detach(), proj[:, :4], sp, tp)
    with pytest.raises(TypeError):
        tjbu.jbu_filter(hr.detach(), proj.bfloat16(), sp, tp)


# -- JBU modules ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jbu_stack():
    """A JAX JBUStack (dim 48) with random params, and the port's copy."""
    dim = 48
    feats = jnp.zeros((1, 4, 4, dim))
    image = jnp.zeros((1, 56, 56, 3))
    params = jax.jit(jfeatup.JBUStack(dim, fused=False).init)(
        jax.random.PRNGKey(5), feats, image)["params"]
    # a non-default temperature and sigma exercise both learned scalars
    params = dict(params)
    params["up2"] = dict(params["up2"], range_temp=jnp.float32(0.7),
                         sigma_spatial=jnp.float32(0.8))
    port = tfeatup.JBUStack(dim)
    port.load_state_dict(jbu_state_dict_from_jax(_np(params)), strict=True)
    return dim, params, port.eval()


def test_jbu_module_matches_jax_scan(jbu_stack):
    # one stage, fp32, scan formulation on both sides: rtol/atol 1e-5
    dim, params, port = jbu_stack
    rng = np.random.default_rng(6)
    src = rng.normal(size=(2, 8, 11, dim)).astype(np.float32)
    guide = rng.random((2, 16, 22, 3), dtype=np.float32)
    want = jfeatup.JBU(dim, fused=False).apply({"params": params["up2"]},
                                               jnp.asarray(src), jnp.asarray(guide))
    with torch.no_grad():
        got = port.up2(torch.from_numpy(src), torch.from_numpy(guide))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_jbu_stack_matches_jax(jbu_stack):
    # the 6-level pyramid from a 4x4 grid and a 56² image (the last pool
    # upsamples 56 -> 64): fp32, rtol/atol 1e-5
    dim, params, port = jbu_stack
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(2, 4, 4, dim)).astype(np.float32)
    image = rng.random((2, 56, 56, 3), dtype=np.float32)
    want = jfeatup.JBUStack(dim, fused=False).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(image))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(image))
    assert [g.shape[1] for g in got] == [4, 8, 16, 32, 64, 64]
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_jbu_fused_flag_routes(jbu_stack, monkeypatch):
    # CPU tensors take the plain (scan) version whether or not ``fused`` is
    # set; the kernel route is held on the card in tests/test_torch_kernels.py
    dim, _, port = jbu_stack
    calls = []
    monkeypatch.setattr(tfeatup, "jbu_filter", lambda *a: calls.append(1))
    src = torch.rand(1, 4, 4, dim)
    guide = torch.rand(1, 8, 8, 3)
    assert port.up1.fused
    try:
        with torch.no_grad():
            fused = port.up1(src, guide)
            port.up1.fused = False
            plain = port.up1(src, guide)
    finally:
        port.up1.fused = True
    assert calls == []
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
