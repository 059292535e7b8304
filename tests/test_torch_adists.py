"""The port's ADISTS (ops/windowed.py, ops/cuda/windowed_tsd.py' plain
version, core/adists.py) against the JAX package on the CPU. Inputs come
from numpy seeds and the VGG weights from ``init_vgg16_params(seed=0)``
through ``compat.from_jax``; the JAX side runs under ``jax.jit``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.config import ADISTSConfig as TConfig
from nerf_qa_torch.core import adists as ta
from nerf_qa_torch.ops import windowed as tw
from nerf_qa_torch.ops.cuda import windowed_tsd as ttsd
from nerf_qa_tpu.config import ADISTSConfig as JConfig
from nerf_qa_tpu.core import adists as ja
from nerf_qa_tpu.core.vgg import vgg16_pyramid
from nerf_qa_tpu.ops import windowed as jw
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def images():
    # 96x96: stages 0-2 fit the 21x21 window, stages 3-5 take the global
    # branch (as tests/test_adists_parity.py)
    rng = np.random.default_rng(11)
    x = rng.random((2, 96, 96, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape).astype(np.float32), 0, 1)
    return x, y


@pytest.fixture(scope="module")
def jax_feats(jax_params, images):
    """The JAX pyramid of ``x`` as numpy: both packages' statistics are
    compared on these identical features."""
    feats = jax.jit(vgg16_pyramid)(jax_params, jnp.asarray(images[0]))
    return [np.asarray(f) for f in feats]


def _jax_forward(jax_params, x, y, cfg=JConfig(), **kw):
    fn = jax.jit(lambda p, a, b: ja.forward(p, a, b, cfg, **kw))
    return np.asarray(fn(jax_params, jnp.asarray(x), jnp.asarray(y)))


@pytest.fixture(scope="module")
def jax_scores(jax_params, images):
    x, y = images
    return {
        "per_image": _jax_forward(jax_params, x, y, as_loss=False),
        "loss": _jax_forward(jax_params, x, y),
        "map": _jax_forward(jax_params, x, y, as_map=True),
    }


@pytest.mark.parametrize("window,sigma", [(21, 7.0), (11, 1.5), (5, None)])
def test_gaussian_taps_equal(window, sigma):
    sigma = sigma or window / 3.0
    assert tw.gaussian_taps(window, sigma) == jw.gaussian_taps(window, sigma)


@pytest.mark.parametrize("shape,window", [((1, 40, 48, 8), 21), ((2, 21, 30, 3), 21),
                                          ((1, 17, 13, 5), 7), ((1, 24, 1530, 2), 21)])
def test_window_mean_matches_jax(shape, window):
    # fp32 both sides (HIGHEST precision in JAX): rtol 1e-5, atol 1e-6; the
    # last shape (H + W > BAND_MAX_HW) takes the convolution body
    x = np.random.default_rng(12).random(shape, dtype=np.float32)
    want = np.asarray(jw.window_mean(jnp.asarray(x), window))
    got = tw.window_mean(_t(x), window)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_window_mean_bodies_agree():
    x = torch.rand(2, 33, 47, 6, generator=torch.Generator().manual_seed(1))
    taps = tw.gaussian_taps(21, 7.0)
    torch.testing.assert_close(tw.window_mean_conv(x, taps), tw.window_mean_band(x, taps),
                               rtol=1e-5, atol=1e-6)


def test_window_mean_upcasts_bf16():
    x = torch.rand(1, 30, 25, 4, generator=torch.Generator().manual_seed(0))
    b = x.to(torch.bfloat16)
    torch.testing.assert_close(tw.window_mean(b), tw.window_mean(b.float()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(21, 21), (20, 64), (64, 20), (16, 16), (256, 1920)])
def test_fits_window_matches_jax(h, w):
    assert tw.fits_window(h, w) == jw.fits_window(h, w)


@pytest.mark.parametrize("block_pixels", [448 * 448, 0])
def test_compute_prob_matches_jax(jax_feats, block_pixels):
    # identical features; the blocked gamma (block_pixels 0) against JAX's
    # blocked scan. The min/max renormalisation amplifies fp32 rounding of
    # gamma: atol 1e-5
    want = ja.compute_prob([jnp.asarray(f) for f in jax_feats],
                           block_pixels=block_pixels)
    got = ta.compute_prob([_t(f) for f in jax_feats], block_pixels=block_pixels)
    assert len(got) == len(want) == 6
    for k, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape, k
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=f"stage {k}")


@pytest.mark.parametrize("fits", [True, False])
def test_prob_update_matches_jax(fits):
    rng = np.random.default_rng(3)
    gamma = rng.random((2, 12, 14, 1) if fits else (2, 1, 1, 1)).astype(np.float32)
    prod = rng.random((2, 6, 7, 1)).astype(np.float32)
    want = np.asarray(ja._prob_update(jnp.asarray(gamma), jnp.asarray(prod), fits))
    got = ta._prob_update(_t(gamma), _t(prod), fits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_windowed_gamma_sum_matches_jax(jax_feats):
    f = jax_feats[1]  # 96x96x64: four blocks of 16, and 64 = 3·21 + 1
    want = np.asarray(ja.windowed_gamma_sum(jnp.asarray(f), 21, None, 21))
    got = ta.windowed_gamma_sum(_t(f), 21, 21)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stage", [0, 2, 5])
def test_entropy_matches_jax(jax_feats, stage):
    f = jax_feats[stage]
    np.testing.assert_allclose(ta.channel_entropy(_t(f)).numpy(),
                               np.asarray(ja.channel_entropy(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.entropy_weights(_t(f)).numpy(),
                               np.asarray(ja.entropy_weights(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-6)


def _jax_tsd_composition(fx, fy, ps, weights, ws=21):
    """The fp32 window_mean composition of tests/test_windowed_tsd_kernel.py."""
    fx, fy = jnp.asarray(fx), jnp.asarray(fy)
    xm = jw.window_mean(fx, ws)
    ym = jw.window_mean(fy, ws)
    xv = jw.window_mean(fx * fx, ws) - jnp.square(xm)
    yv = jw.window_mean(fy * fy, ws) - jnp.square(ym)
    cov = jw.window_mean(fx * fy, ws) - xm * ym
    t = (2 * xm * ym + 1e-6) / (jnp.square(xm) + jnp.square(ym) + 1e-6)
    s = (2 * cov + 1e-6) / (xv + yv + 1e-6)
    p = jnp.asarray(ps)[..., None]
    d = ((1.0 - p) * t + p * s) * jnp.asarray(weights)[:, None, None, :]
    return np.asarray(d.sum(axis=-1))


def _tsd_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    fx = np.abs(rng.normal(size=shape)).astype(np.float32)
    fy = np.abs(fx + 0.3 * rng.normal(size=shape)).astype(np.float32)
    ps = rng.random((n, h - 20, w - 20), dtype=np.float32)
    weights = rng.random((n, c), dtype=np.float32)
    return fx, fy, ps, weights


@pytest.mark.parametrize("shape", [(2, 32, 32, 24), (1, 64, 48, 3), (2, 37, 53, 5)])
@pytest.mark.parametrize("scaled", [False, True])
def test_plain_tsd_matches_jax_composition(shape, scaled):
    # fp32 on both sides: rtol 1e-5, atol 1e-5 (sums of C ratios near 1).
    # Scaled: the port scales raw moments by the inverse L2 norms, JAX
    # windows the normalised features
    fx, fy, ps, weights = _tsd_inputs(shape)
    ix = 1 / np.sqrt((fx ** 2).sum(axis=(1, 2)))
    iy = 1 / np.sqrt((fy ** 2).sum(axis=(1, 2)))
    if scaled:
        want = _jax_tsd_composition(fx * ix[:, None, None], fy * iy[:, None, None],
                                    ps, weights)
        got = ttsd.windowed_tsd(_t(fx), _t(fy), _t(ps), _t(weights),
                                inv_x=_t(ix), inv_y=_t(iy))
    else:
        want = _jax_tsd_composition(fx, fy, ps, weights)
        got = ttsd.windowed_tsd(_t(fx), _t(fy), _t(ps), _t(weights))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channel_block", [1, 5, 16, 64])
def test_plain_tsd_channel_blocks_agree(channel_block):
    fx, fy, ps, weights = (_t(a) for a in _tsd_inputs((1, 30, 41, 24), seed=1))
    want = ttsd.windowed_tsd_plain(fx, fy, ps, weights, channel_block=24)
    got = ttsd.windowed_tsd_plain(fx, fy, ps[..., None], weights,
                                  channel_block=channel_block)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_plain_tsd_matches_jax_kernel_interpret():
    # the JAX Pallas kernel in interpret mode, as its own test runs it; it
    # casts its inputs to bf16 and the port does not: its 3e-2 bar
    from nerf_qa_tpu.ops.pallas.windowed_tsd import windowed_tsd as jtsd

    rng = np.random.default_rng(0)
    shape = (2, 32, 32, 24)
    fx = rng.normal(size=shape).astype(np.float32) * 0.05
    fy = fx + rng.normal(size=shape).astype(np.float32) * 0.01
    ps = rng.random((2, 12, 12), dtype=np.float32)
    weights = rng.random((2, 24), dtype=np.float32)
    want = np.asarray(jtsd(fx, fy, ps, weights))
    got = ttsd.windowed_tsd(_t(fx), _t(fy), _t(ps), _t(weights)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_tsd_wrapper_checks_inputs():
    fx, fy, ps, weights = (_t(a) for a in _tsd_inputs((1, 25, 26, 4)))
    with pytest.raises(ValueError, match="window"):
        ttsd.windowed_tsd(fx[:, :20], fy[:, :20], ps, weights)
    with pytest.raises(ValueError, match="ps"):
        ttsd.windowed_tsd(fx, fy, ps[:, 1:], weights)
    with pytest.raises(ValueError, match="weights"):
        ttsd.windowed_tsd(fx, fy, ps, weights[:, :3])
    with pytest.raises(ValueError, match="inv_x"):
        ttsd.windowed_tsd(fx, fy, ps, weights, inv_x=weights)
    with pytest.raises(TypeError):
        ttsd.windowed_tsd(fx.double(), fy.double(), ps, weights)
    with pytest.raises(RuntimeError, match="no backward"):
        ttsd.windowed_tsd(fx.requires_grad_(True), fy, ps, weights)


def test_forward_per_image_matches_jax(torch_model, images, jax_scores):
    # fp32 end to end at 96²: atol 1e-4, the bar JAX holds against its
    # torch oracle (tests/test_adists_parity.py)
    x, y = images
    got = ta.forward(torch_model, _t(x), _t(y), TConfig(), as_loss=False)
    gap = float(np.abs(got.numpy() - jax_scores["per_image"]).max())
    print(f"ADISTS fp32 per-image gap port vs JAX: {gap:.3e}")
    assert tuple(got.shape) == (2,) and gap <= 1e-4


def test_forward_loss_and_map_match_jax(torch_model, images, jax_scores):
    x, y = images
    loss = ta.forward(torch_model, _t(x), _t(y))
    assert loss.dim() == 0
    assert abs(float(loss) - float(jax_scores["loss"])) <= 1e-4
    amap = ta.forward(torch_model, _t(x), _t(y), as_map=True)
    assert tuple(amap.shape) == (2, 96, 96)
    np.testing.assert_allclose(amap.numpy(), jax_scores["map"], atol=1e-4)


def test_forward_blocked_route(torch_model, jax_params, images, jax_scores):
    # every fitting stage channel-blocked: against the port's unblocked
    # route at rtol 1e-5, atol 1e-6 (as JAX holds its own blocked scan),
    # and against JAX with the same threshold at 1e-4
    x, y = images
    blocked = TConfig(block_pixels_threshold=0, channel_block=16)
    got = ta.forward(torch_model, _t(x), _t(y), blocked, as_loss=False).numpy()
    base = ta.forward(torch_model, _t(x), _t(y), TConfig(), as_loss=False).numpy()
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-6)
    want = _jax_forward(jax_params, x, y, JConfig(block_pixels_threshold=0),
                        as_loss=False)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_config_matches_jax_bf16(torch_model, jax_params, images):
    # bf16 pyramid on both sides; bf16 rounds at other places in the two
    # frameworks and JAX's windows run at DEFAULT precision: atol 5e-3
    x, y = images
    want = _jax_forward(jax_params, x, y, JConfig(compute_dtype="bfloat16"),
                        as_loss=False)
    got = ta.forward(torch_model, _t(x), _t(y), TConfig(compute_dtype="bfloat16"),
                     as_loss=False).numpy()
    gap = float(np.abs(got - want).max())
    print(f"ADISTS bf16 gap port vs JAX: {gap:.3e}")
    assert gap <= 5e-3


def test_fused_and_plain_routes_agree_on_cpu(torch_model, images):
    # on CPU tensors fused_tsd=True takes the plain version through the
    # wrapper (one channel block per stage there): same numbers up to the
    # channel blocking's summation order
    x, y = images
    a = ta.forward(torch_model, _t(x), _t(y), TConfig(fused_tsd=True), as_loss=False)
    b = ta.forward(torch_model, _t(x), _t(y), TConfig(fused_tsd=False), as_loss=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_identical_pair_scores_zero(torch_model, images):
    x, _ = images
    got = ta.forward(torch_model, _t(x), _t(x), as_loss=False)
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-5)


def test_forward_is_asymmetric(torch_model, images):
    # entropy weights and gamma come from x only: swapping the pair moves
    # the score (the JAX CLI passes x = dist, prep_fr passes x = ref)
    x, y = images
    a = ta.forward(torch_model, _t(x), _t(y), as_loss=False).numpy()
    b = ta.forward(torch_model, _t(y), _t(x), as_loss=False).numpy()
    assert np.abs(a - b).max() > 1e-5


def test_mismatched_shapes_raise(torch_model):
    with pytest.raises(ValueError, match="identically shaped"):
        ta.forward(torch_model, torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 48, 3))


def test_forward_once_is_the_pyramid(torch_model, images):
    x = _t(images[0])
    feats = ta.forward_once(torch_model, x)
    assert [f.shape[-1] for f in feats] == [3, 64, 128, 256, 512, 512]
    torch.testing.assert_close(feats[3], torch_model(x)[3], rtol=0, atol=0)
