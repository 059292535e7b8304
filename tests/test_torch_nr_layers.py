"""The port's NR layers (ConvLayer, ConvTransposeLayer, Mlp, Attention,
TransformerBlock) and the ViT-S/14 against the JAX package, on the CPU,
with weights through compat/from_jax and inputs made by numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.models.nr import layers as tlayers
from nerf_qa_torch.models.nr.vit import ViTS14
from nerf_qa_tpu.models.nr import layers as jlayers
from nerf_qa_tpu.models.nr.vit import ViTS14 as JViT
from tests.torch_parity import one_torch_thread  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, *args, seed=0):
    return jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"]


def _randomize(params, seed):
    """Replace every leaf by noise, so zero biases and unit scales of the
    init cannot hide a dropped or swapped parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, np.shape(a))).astype(np.float32),
        params)


@pytest.mark.parametrize("activation", [True, False])
@pytest.mark.parametrize("cin,cout", [(24, 40), (387, 387)])
def test_conv_layer_matches_jax(activation, cin, cout):
    # conv + ChannelNorm (+ erf GELU), fp32 in true fp32: rtol/atol 1e-5
    x = np.random.default_rng(1).normal(size=(2, 9, 7, cin)).astype(np.float32)
    mod = jlayers.ConvLayer(cout, activation=activation)
    params = _randomize(_init(mod, jnp.asarray(x)), 2)
    want = mod.apply({"params": params}, jnp.asarray(x))
    sd = {}
    from_jax._conv_layer(sd, "", params)
    port = tlayers.ConvLayer(cin, cout, activation=activation).eval()
    port.load_state_dict({k[1:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tlayers.nhwc(port(tlayers.nchw(torch.from_numpy(x))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_conv_transpose_layer_matches_jax(hw):
    # torch's ConvTranspose2d(3, s2, p1, op1) vs the JAX layer's padding
    # ((1, 2), (1, 2)) with the flipped kernel: exact 2x, rtol/atol 1e-5
    x = np.random.default_rng(3).normal(size=(2, *hw, 20)).astype(np.float32)
    mod = jlayers.ConvTransposeLayer(12, activation=False)
    params = _randomize(_init(mod, jnp.asarray(x)), 4)
    want = mod.apply({"params": params}, jnp.asarray(x))
    sd = {}
    from_jax._conv_layer(sd, "", params)
    port = tlayers.ConvTransposeLayer(20, 12).eval()
    port.load_state_dict({k[1:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tlayers.nhwc(port(tlayers.nchw(torch.from_numpy(x))))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qkv_bias,layer_scale,eps", [(True, 1e-5, 1e-6),
                                                      (False, None, 1e-5),
                                                      (True, 0.7, 1e-5)])
def test_transformer_block_matches_jax(qkv_bias, layer_scale, eps):
    # pre-norm block, 8 heads, fp32: rtol/atol 1e-5. qkv_bias=False and no
    # LayerScale is the reference decoder's block; the JAX block always
    # has both, so they are set to their identity values there.
    dim = 64
    x = np.random.default_rng(5).normal(size=(2, 17, dim)).astype(np.float32)
    mod = jlayers.TransformerBlock(dim, 8, layer_scale_init=layer_scale or 1.0,
                                   norm_eps=eps)
    params = _randomize(_init(mod, jnp.asarray(x)), 6)
    attn = dict(params["Attention_0"])
    if not qkv_bias:
        attn["Dense_0"] = dict(attn["Dense_0"], bias=np.zeros(3 * dim, np.float32))
    params = dict(params, Attention_0=attn)
    if layer_scale is None:
        params = dict(params, LayerScale_0={"gamma": np.ones(dim, np.float32)},
                      LayerScale_1={"gamma": np.ones(dim, np.float32)})
    want = mod.apply({"params": params}, jnp.asarray(x))
    sd = {}
    from_jax._block(sd, "b", params, qkv_bias=None if not qkv_bias else True,
                    layer_scale=None if layer_scale is None else True)
    port = tlayers.TransformerBlock(dim, 8, layer_scale_init=layer_scale,
                                    norm_eps=eps, qkv_bias=qkv_bias).eval()
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mlp_and_attention_match_jax():
    dim = 48
    x = np.random.default_rng(7).normal(size=(3, 11, dim)).astype(np.float32)
    for jmod, port, key in ((jlayers.Mlp(4 * dim, dim), tlayers.Mlp(dim, 4 * dim), "mlp"),
                            (jlayers.Attention(dim, 6), tlayers.Attention(dim, 6), "attn")):
        params = _randomize(_init(jmod, jnp.asarray(x)), 8)
        want = jmod.apply({"params": params}, jnp.asarray(x))
        names = ("fc1", "fc2") if key == "mlp" else ("qkv", "proj")
        sd = {}
        for name, dense in zip(names, ("Dense_0", "Dense_1")):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = from_jax._dense(params[dense])
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def vit_pair():
    jvit = JViT(depth=2)
    params = _randomize(_init(jvit, jnp.zeros((1, 56, 56, 3))), 9)
    port = ViTS14(depth=2, grid_size=4)
    port.load_state_dict(from_jax.vit_state_dict_from_jax(_np(params)), strict=True)
    return jvit, params, port.eval()


def test_vit_matches_jax(vit_pair):
    # patch conv, patch-only position embeddings, 2 blocks (LayerNorm eps
    # 1e-6, LayerScale), final norm; fp32 in true fp32: atol 1e-4
    jvit, params, port = vit_pair
    x = np.random.default_rng(10).random((2, 56, 56, 3), dtype=np.float32)
    want = jvit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got["grid"] == want["grid"] == (4, 4)
    for k in ("x_norm_clstoken", "x_norm_regtokens", "x_norm_patchtokens"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_vit_rejects_wrong_grid(vit_pair):
    _, _, port = vit_pair
    with pytest.raises(ValueError, match="patch grid"):
        port(torch.zeros(1, 70, 70, 3))
