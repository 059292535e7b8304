"""The port's classical IQA metrics (``nerf_qa_torch/eval/iqa.py``) against
the JAX package's (``nerf_qa_tpu/eval/iqa.py``) on the CPU: the same seeded
numpy pairs through each of the eleven metrics, the same VGG weights
(``init_vgg16_params(seed=0)`` carried across) and the same seeded ``lin``
weights for LPIPS and ST-LPIPS.

Tolerance: fp32, rel 1e-4 / atol 1e-5 for every metric but MAD. The
largest gaps measured at these sizes: VIF 2e-5 relative (its log10 sums
over variances of luminance in [0, 255], summed in another order by the two
conv backends), FSIM and FSIMc below 1e-6. MAD is held to JAX at rel 1e-3
(measured 4.7e-4 on the smooth 64x80 pair) and to its own float64 run at
rel 1e-4 (measured 1.1e-5). The port takes MAD's block moments in float64;
JAX's float32 raw moments cancel: on the smooth pair its detection and
appearance indices lie 3e-4 to 9e-4 from float64, and on the textured
176x184 pair one image's appearance index is 10.6 where float64 gives 1.32
(ROADMAP Queue 3, the JAX package's faults)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat import pretrained as tpre
from nerf_qa_torch.compat.from_jax import lpips_lin_from_jax
from nerf_qa_torch.eval import iqa as tiqa
from nerf_qa_tpu.compat import pretrained as jpre
from nerf_qa_tpu.eval import iqa as jiqa
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

RTOL = 1e-4
ATOL = 1e-5
MAD_RTOL = 1e-3  # see the module docstring


def smooth_pair(n, h, w, sigma=0.05, seed=0):
    """A smooth textured image batch and a noisy copy, NHWC fp32 in [0, 1]
    (the masking models of MAD and VIF need structure, not white noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for i in range(n):
        f = 5.0 + 3.0 * i
        imgs.append(np.stack([
            0.5 + 0.4 * np.sin(xx / f) * np.cos(yy / (f + 4.0)),
            (xx + yy) / (h + w),
            0.5 + 0.3 * np.sin((xx + 2 * yy) / (f + 2.0)),
        ], axis=-1))
    x = np.clip(np.stack(imgs) + rng.normal(0, 0.02, (n, h, w, 3)), 0, 1)
    y = np.clip(x + rng.normal(0, sigma, x.shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


def both(jfn, tfn, x, y):
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(y)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (x.shape[0],)
    return got, want


@pytest.fixture(scope="module")
def lin():
    rng = np.random.default_rng(3)
    return [rng.random(c).astype(np.float32) for c in jiqa.LPIPS_STAGE_CHANNELS]


HW = (64, 80)
PLAIN = {
    "psnr": (jiqa.psnr, tiqa.psnr),
    "ssim": (jiqa.ssim, tiqa.ssim),
    "gmsd": (jiqa.gmsd, tiqa.gmsd),
    "vif": (jiqa.vif, tiqa.vif),
    "fsim": (jiqa.fsim, tiqa.fsim),
    "fsimc": (jiqa.fsimc, tiqa.fsimc),
    "nlpd": (lambda a, b: jiqa.nlpd(a, b, levels=jiqa.nlpd_max_levels(*HW)),
             lambda a, b: tiqa.nlpd(a, b, levels=tiqa.nlpd_max_levels(*HW))),
    "mad": (jiqa.mad, tiqa.mad),
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_metric_matches_jax(name):
    x, y = smooth_pair(2, *HW)
    got, want = both(*PLAIN[name], x, y)
    rtol = MAD_RTOL if name == "mad" else RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL, err_msg=name)


def textured_pair(n, h, w, seed=22):
    """Sinusoid textures of random frequency per image and channel, lightly
    noisy, and noisy copies (chip_smoke.textured_pairs' recipe in numpy)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 4.0 + 24.0 * rng.random((n, 1, 1, 3))
    x = 0.5 + 0.4 * np.sin(xx[None, :, :, None] / f) * np.cos(yy[None, :, :, None] / (f + 3.0))
    x = np.clip(x + 0.02 * rng.normal(size=x.shape), 0, 1)
    y = np.clip(x + 0.05 * rng.normal(size=x.shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("kind", ["smooth", "textured"])
def test_mad_stages_match_float64(kind):
    x, y = smooth_pair(2, *HW) if kind == "smooth" else textured_pair(2, 176, 184)
    ref, dst = tiqa._lum255(torch.from_numpy(x)), tiqa._lum255(torch.from_numpy(y))
    for stage in (tiqa._mad_detect, tiqa._mad_appear):
        got = stage(ref, dst).numpy()
        want = stage(ref.double(), dst.double()).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=stage.__name__)
    if kind == "textured":
        # JAX's float32 block moments: the recorded fault, not a bar
        jref, jdst = jiqa._lum255(jnp.asarray(x)), jiqa._lum255(jnp.asarray(y))
        appear = np.asarray(jiqa._mad_appear(jref, jdst))
        assert (appear > 2 * tiqa._mad_appear(ref.double(), dst.double()).numpy()).any()


def test_ssim_return_cs_matches_jax():
    x, y = smooth_pair(2, 48, 64, seed=1)
    want = jiqa.ssim(jnp.asarray(x), jnp.asarray(y), return_cs=True)
    got = tiqa.ssim(torch.from_numpy(x), torch.from_numpy(y), return_cs=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_ms_ssim_matches_jax():
    # five scales need a min side of 11 * 2^4 = 176
    x, y = smooth_pair(1, 176, 184, seed=2)
    got, want = both(jiqa.ms_ssim, tiqa.ms_ssim, x, y)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(64, 80), (67, 75)])
@pytest.mark.parametrize("name", ["lpips", "st_lpips"])
def test_lpips_matches_jax(name, hw, jax_params, torch_model, lin):  # noqa: F811
    # (67, 75): odd sizes at every stage, where the max pool and the
    # MaxBlurPool's reflect-padded stride-2 blur must give JAX's shapes
    x, y = smooth_pair(2, *hw, seed=4)
    jfn, tfn = getattr(jiqa, name), getattr(tiqa, name)
    for jl, tl in ((lin, lpips_lin_from_jax(lin)), (None, None)):
        got, want = both(lambda a, b: jfn(jax_params, a, b, jl),
                         lambda a, b: tfn(torch_model, a, b, tl), x, y)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def test_st_lpips_pyramid_shapes_match_jax(jax_params, torch_model):  # noqa: F811
    x = np.random.default_rng(5).random((1, 67, 75, 3), dtype=np.float32)
    want = jiqa._st_lpips_pyramid(jax_params, jnp.asarray(x))
    got = tiqa._st_lpips_pyramid(torch_model, torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.permute(0, 2, 3, 1).shape) == w.shape
        # features up to ~10 after five stages of random He convs: the
        # absolute bar scales with the stage's largest value
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(w).max())))


def test_fsim_downsample_path_matches_jax():
    # min side 384 -> FSIM.m's downsampling factor round(384 / 256) = 2
    x, y = smooth_pair(1, 384, 400, seed=6)
    for jfn, tfn in ((jiqa.fsim, tiqa.fsim), (jiqa.fsimc, tiqa.fsimc)):
        got, want = both(jfn, tfn, x, y)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_median_averages_the_two_middle_values():
    # an even count whose two middle values differ: jnp.median averages
    # them, torch.median would return the lower one
    v = np.arange(24, dtype=np.float32).reshape(2, 3, 4) ** 2
    got = tiqa._median_hw(torch.from_numpy(v))
    want = np.asarray(jnp.median(jnp.asarray(v), axis=(1, 2), keepdims=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0, 0, 0]) == (25.0 + 36.0) / 2
    assert float(torch.median(torch.from_numpy(v[0]))) != float(got[0, 0, 0])
    odd = np.random.default_rng(0).random((1, 3, 5), dtype=np.float32)
    np.testing.assert_array_equal(tiqa._median_hw(torch.from_numpy(odd)).numpy(),
                                  np.median(odd, axis=(1, 2), keepdims=True))


def test_identities(torch_model):  # noqa: F811
    x, _ = smooth_pair(2, 64, 80, seed=7)
    t = torch.from_numpy(x)
    for fn in (tiqa.ssim, tiqa.vif, tiqa.fsim, tiqa.fsimc):
        np.testing.assert_allclose(fn(t, t).numpy(), 1.0, atol=1e-5, err_msg=fn.__name__)
    assert (tiqa.psnr(t, t).numpy() > 100).all()
    for fn in (tiqa.gmsd, tiqa.mad, lambda a, b: tiqa.nlpd(a, b, levels=5),
               lambda a, b: tiqa.lpips(torch_model, a, b),
               lambda a, b: tiqa.st_lpips(torch_model, a, b)):
        np.testing.assert_allclose(fn(t, t).numpy(), 0.0, atol=1e-5)


def test_metrics_run_in_true_fp32(monkeypatch):
    """Every conv a metric issues runs with TF32 off (the JAX module's
    Precision.HIGHEST), and the flags come back after the call."""
    seen = []
    real = tiqa._window_filter

    def spy(x, taps):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(x, taps)

    monkeypatch.setattr(tiqa, "_window_filter", spy)
    torch.backends.cudnn.allow_tf32 = True
    x, y = smooth_pair(1, 48, 48)
    tiqa.ssim(torch.from_numpy(x), torch.from_numpy(y))
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32


def _official_lin_checkpoint(path, lin, key="lin{k}.model.1.weight"):
    torch.save({key.format(k=k): torch.from_numpy(w.reshape(1, -1, 1, 1))
                for k, w in enumerate(lin)}, path)


@pytest.mark.parametrize("key", ["lin{k}.model.1.weight", "lins.{k}.model.1.weight"])
def test_lpips_weights_resolve_like_jax(tmp_path, monkeypatch, lin, key):
    path = str(tmp_path / "vgg.pth")
    _official_lin_checkpoint(path, lin, key)
    for t_resolve, j_resolve in ((tpre.resolve_lpips_weights, jpre.resolve_lpips_weights),
                                 (tpre.resolve_stlpips_weights,
                                  jpre.resolve_stlpips_weights)):
        got, want = t_resolve(path), j_resolve(path)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the environment variable is the fallback of an absent path
    monkeypatch.setenv(tpre.ENV_LPIPS, path)
    assert tpre.ENV_LPIPS == jpre.ENV_LPIPS and tpre.ENV_STLPIPS == jpre.ENV_STLPIPS
    assert len(tpre.resolve_lpips_weights()) == 5


def test_lpips_weights_absent_warn_and_fall_back(monkeypatch, capsys):
    monkeypatch.delenv(tpre.ENV_LPIPS, raising=False)
    monkeypatch.delenv(tpre.ENV_STLPIPS, raising=False)
    assert tpre.resolve_lpips_weights() is None
    assert tpre.resolve_stlpips_weights() is None
    err = capsys.readouterr().err
    assert "uniform channel weights" in err and os.environ.get(tpre.ENV_LPIPS) is None
