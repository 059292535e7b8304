"""Classical IQA metrics: PSNR, SSIM, MS-SSIM, LPIPS, ST-LPIPS, GMSD, VIF,
FSIM/FSIMc, NLPD and MAD, batched, on the GPU.

Counterpart of ``nerf_qa_tpu/eval/iqa.py``. The reference's prep/analysis
compare DISTS against SSIM/PSNR/LPIPS/... columns shipped inside its score
CSVs (prep.py:344-394, results_table*.tex competitor rows); this module
computes them natively, so the comparison pipeline is self-contained.

Every public metric takes NHWC tensors in [0, 1] and returns one fp32 score
per image, as the JAX functions do. Inside, the work is depthwise and dense
``F.conv2d``, ``F.max_pool2d`` / ``F.avg_pool2d`` and ``torch.fft`` in
complex64: the JAX module leaves all of it to XLA, and no metric here has a
kernel of its own.

Precision: each metric runs inside ``config.true_fp32()``. The JAX module
forces ``Precision.HIGHEST`` on every conv, because the W(x²) − W(x)²
variances of SSIM and VIF cancel: with bf16-grade (or TF32) operands a
variance goes negative and a near-zero SSIM denominator blows a window up
(a frame SSIM of 1.05 was observed that way). cuDNN and cuBLAS take fp32
through TF32 by default, so the flag matters on the card exactly as
HIGHEST does on the TPU. LPIPS's fp32 VGG runs under the same context.

Helper layouts: channel helpers (``_window_filter``, ``_downsample2``,
``_max_blur_pool``) take NCHW; luminance helpers take NHW, as in JAX.
The frequency-domain filters (log-Gabor banks, the CSF) are numpy float64
cast to float32 before they meet the image, as JAX with x64 off does;
they are built once per frame size and device (a bounded cache). MAD's
block moments are taken in float64 (``_mad_block_stats``).

SSIM follows Wang et al. 2004: 11x11 Gaussian window (sigma 1.5), K1=0.01,
K2=0.03, per channel and averaged. MS-SSIM uses the standard 5-scale
weights. LPIPS follows Zhang et al. 2018 (vgg variant): scaling layer, the
MAX-pool VGG16 pyramid (relu{1_2,2_2,3_3,4_3,5_3}) with the DISTS pyramid's
conv weights, unit-normalised features, learned per-channel ``lin``
weights (``compat.pretrained.resolve_lpips_weights``; without a checkpoint
uniform 1/C: structure-identical, calibration-meaningless), spatial mean,
stage sum.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_qa_torch.config import true_fp32
from nerf_qa_torch.core.vgg import VGG16Pyramid, _conv_relu, _nchw

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)

# frequency-domain filter sets kept per (rows, cols, device)
_FILTER_CACHE = 8


def _fp32(fn):
    """Run ``fn`` in true fp32 (no TF32), the JAX module's HIGHEST."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with true_fp32():
            return fn(*args, **kwargs)
    return wrapped


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


@_fp32
def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over NHWC batches."""
    mse = (x.float() - y.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([
        math.exp(-((i - size // 2) ** 2) / (2 * sigma**2)) for i in range(size)
    ])
    return (g / g.sum()).astype(np.float32)


def _window_filter(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable VALID depthwise filtering over NCHW (true fp32: the
    variances these moments feed cancel, see the module docstring)."""
    c = x.shape[1]
    t = _t(taps, x)
    x = F.conv2d(x, t.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, t.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_nchw(x: torch.Tensor, y: torch.Tensor, max_val: float,
               window_size: int, sigma: float):
    """(per-image SSIM, per-image mean cs) of fp32 NCHW batches."""
    taps = _gaussian_kernel(window_size, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _window_filter(x, taps)
    mu_y = _window_filter(y, taps)
    var_x = _window_filter(x * x, taps) - mu_x * mu_x
    var_y = _window_filter(y * y, taps) - mu_y * mu_y
    cov = _window_filter(x * y, taps) - mu_x * mu_y
    cs_map = (2 * cov + c2) / (var_x + var_y + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x.square() + mu_y.square() + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


@_fp32
def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    return_cs: bool = False,
):
    """Per-image SSIM over NHWC batches (channel-averaged)."""
    s, cs = _ssim_nchw(x.float().permute(0, 3, 1, 2), y.float().permute(0, 3, 1, 2),
                       max_val, window_size, sigma)
    return (s, cs) if return_cs else s


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x average pooling over NCHW (MS-SSIM scale step; odd edges drop)."""
    return F.avg_pool2d(x, 2)


_LPIPS_SHIFT = (-0.030, -0.088, -0.188)  # lpips ScalingLayer constants
_LPIPS_SCALE = (0.458, 0.448, 0.450)
LPIPS_STAGE_CHANNELS = (64, 128, 256, 512, 512)


def _lpips_input(x: torch.Tensor) -> torch.Tensor:
    """NHWC [0, 1] -> the scaling layer's output as channels_last NCHW."""
    h = (x.float() * 2.0 - 1.0 - _t(_LPIPS_SHIFT, x)) / _t(_LPIPS_SCALE, x)
    return _nchw(h)


def _stage_convs(vgg: VGG16Pyramid, stage: int):
    return [m for m in vgg.stage(stage).children() if isinstance(m, nn.Conv2d)]


def _lpips_pyramid(vgg: VGG16Pyramid, x: torch.Tensor) -> list[torch.Tensor]:
    """LPIPS's backbone: the STANDARD max-pool VGG16 (torchvision
    features), not DISTS's L2-pool variant: the same conv weights, 2x2
    max pooling between stages. NCHW fp32 features."""
    h = _lpips_input(x)
    feats = []
    for si in range(1, 6):
        if si > 1:
            h = F.max_pool2d(h, 2)
        for conv in _stage_convs(vgg, si):
            h = _conv_relu(h, conv, torch.float32)
        feats.append(h)
    return feats


def _lpips_score(fx, fy, lin_weights) -> torch.Tensor:
    """Stage-summed LPIPS distance between two NCHW feature pyramids:
    unit-normalise channels, weighted squared difference, spatial mean."""
    if lin_weights is None:
        lin_weights = [torch.full((c,), 1.0 / c) for c in LPIPS_STAGE_CHANNELS]
    total = 0.0
    for fa, fb, w in zip(fx, fy, lin_weights):
        na = fa / torch.sqrt(fa.square().sum(dim=1, keepdim=True) + 1e-10)
        nb = fb / torch.sqrt(fb.square().sum(dim=1, keepdim=True) + 1e-10)
        w = torch.as_tensor(w, dtype=torch.float32, device=fa.device).reshape(1, -1, 1, 1)
        total = total + ((na - nb).square() * w).sum(dim=1).mean(dim=(1, 2))
    return total


@_fp32
def lpips(vgg: VGG16Pyramid, x: torch.Tensor, y: torch.Tensor,
          lin_weights=None) -> torch.Tensor:
    """Per-image LPIPS (vgg variant, Zhang et al. 2018) over NHWC [0,1]
    batches. ``lin_weights``: five per-channel (C_k,) vectors (the
    checkpoint's ``lin{k}.model.1.weight`` squeezed); None -> uniform
    1/C_k (uncalibrated)."""
    return _lpips_score(_lpips_pyramid(vgg, x), _lpips_pyramid(vgg, y), lin_weights)


def _max_blur_pool(h: torch.Tensor) -> torch.Tensor:
    """Anti-aliased downsampling (Zhang 2019 MaxBlurPool) over NCHW: 2x2
    max-pool at stride 1, then a [1 2 1] tent blur with reflect padding
    at stride 2, per axis."""
    h = F.max_pool2d(h, 2, stride=1)
    c = h.shape[1]
    taps = torch.tensor([1.0, 2.0, 1.0], device=h.device) / 4.0
    h = F.conv2d(F.pad(h, (0, 0, 1, 1), mode="reflect"),
                 taps.view(1, 1, 3, 1).expand(c, 1, 3, 1), stride=(2, 1), groups=c)
    return F.conv2d(F.pad(h, (1, 1, 0, 0), mode="reflect"),
                    taps.view(1, 1, 1, 3).expand(c, 1, 1, 3), stride=(1, 2), groups=c)


def _st_lpips_pyramid(vgg: VGG16Pyramid, x: torch.Tensor) -> list[torch.Tensor]:
    """ST-LPIPS backbone: the LPIPS VGG16 pyramid with every strided
    max-pool replaced by an anti-aliased MaxBlurPool."""
    h = _lpips_input(x)
    feats = []
    for si in range(1, 6):
        if si > 1:
            h = _max_blur_pool(h)
        for conv in _stage_convs(vgg, si):
            h = _conv_relu(h, conv, torch.float32)
        feats.append(h)
    return feats


@_fp32
def st_lpips(vgg: VGG16Pyramid, x: torch.Tensor, y: torch.Tensor,
             lin_weights=None) -> torch.Tensor:
    """Per-image shift-tolerant LPIPS (Ghildyal & Liu, ECCV 2022) over NHWC
    [0,1] batches, a competitor row of the reference's Test2 results table
    (results_table_test2.tex:11-25): LPIPS with each strided max-pool
    swapped for an anti-aliased MaxBlurPool. The official checkpoints'
    ``lin`` weights share LPIPS's layout ($NERF_QA_STLPIPS_CKPT); None ->
    uniform 1/C_k (uncalibrated but structure-identical)."""
    return _lpips_score(_st_lpips_pyramid(vgg, x), _st_lpips_pyramid(vgg, y),
                        lin_weights)


@_fp32
def ms_ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
            weights=_MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM (Wang 2003). Needs min side >= 11 * 2^(levels-1)."""
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    levels = len(weights)
    vals = []
    for i in range(levels):
        s, cs = _ssim_nchw(x, y, max_val, 11, 1.5)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            x = _downsample2(x)
            y = _downsample2(y)
    total = torch.ones_like(vals[0])
    for v, w in zip(vals, weights):
        total = total * torch.clamp(v, min=0.0) ** w
    return total


def _lum255(v: torch.Tensor) -> torch.Tensor:
    """NHWC [0,1] -> NHW luminance in [0,255] (ITU-R BT.601 weights)."""
    v = v.float() * 255.0
    return 0.299 * v[..., 0] + 0.587 * v[..., 1] + 0.114 * v[..., 2]


def _filter2_valid(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Dense VALID 2-D correlation over an NHW batch (true fp32: VIF's
    variances cancel like SSIM's)."""
    return F.conv2d(x[:, None], _t(win, x)[None, None])[:, 0]


@_fp32
def vif(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pixel-domain Visual Information Fidelity (Sheikh & Bovik 2006, the
    ``vifp_mscale`` formulation), a competitor metric in the reference's
    Test2 results table. Per-image scores over NHWC [0,1] batches; ``x`` is
    the reference image, ``y`` the distorted one. Higher is better; 1.0 for
    identical inputs, > 1 possible for a contrast-enhanced ``y``. A
    constant (zero-information) reference scores 0.0 where vifp_mscale
    divides 0/0 into NaN.

    4 scales; at scale s a Gaussian window of size N=2^(5-s)+1 (std N/5)
    takes local moments of luminance in [0,255]; between scales the images
    are low-passed and subsampled 2x; log10 terms with sigma_nsq=2."""
    ref = _lum255(x)
    dist = _lum255(y)
    sigma_nsq = 2.0
    num = 0.0
    den = 0.0
    for scale in range(1, 5):
        n = 2 ** (4 - scale + 1) + 1
        taps = _gaussian_kernel(n, n / 5.0).astype(np.float64)
        win = np.outer(taps, taps)
        win = (win / win.sum()).astype(np.float32)
        if scale > 1:
            ref = _filter2_valid(ref, win)[:, ::2, ::2]
            dist = _filter2_valid(dist, win)[:, ::2, ::2]
        mu1 = _filter2_valid(ref, win)
        mu2 = _filter2_valid(dist, win)
        sigma1_sq = _filter2_valid(ref * ref, win) - mu1 * mu1
        sigma2_sq = _filter2_valid(dist * dist, win) - mu2 * mu2
        sigma12 = _filter2_valid(ref * dist, win) - mu1 * mu2
        sigma1_sq = torch.clamp(sigma1_sq, min=0.0)
        sigma2_sq = torch.clamp(sigma2_sq, min=0.0)

        g = sigma12 / (sigma1_sq + 1e-10)
        sv_sq = sigma2_sq - g * sigma12
        # the reference MATLAB's edge-case rewrites, as masks
        zero = torch.zeros_like(g)
        tiny1 = sigma1_sq < 1e-10
        g = torch.where(tiny1, zero, g)
        sv_sq = torch.where(tiny1, sigma2_sq, sv_sq)
        sigma1_sq = torch.where(tiny1, zero, sigma1_sq)
        tiny2 = sigma2_sq < 1e-10
        g = torch.where(tiny2, zero, g)
        sv_sq = torch.where(tiny2, zero, sv_sq)
        neg_g = g < 0
        sv_sq = torch.where(neg_g, sigma2_sq, sv_sq)
        g = torch.where(neg_g, zero, g)
        sv_sq = torch.clamp(sv_sq, min=1e-10)

        num = num + torch.log10(1.0 + g * g * sigma1_sq / (sv_sq + sigma_nsq)).sum(dim=(1, 2))
        den = den + torch.log10(1.0 + sigma1_sq / sigma_nsq).sum(dim=(1, 2))
    return num / torch.clamp(den, min=1e-10)


@_fp32
def gmsd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gradient Magnitude Similarity Deviation (Xue et al. 2014), a
    competitor metric in the reference's results tables. Per-image scores
    over NHWC [0,1] batches; 0 for identical inputs.

    Luminance in [0,255], 2x2 average downsample, Prewitt gradients, the
    GMS map with c=170, score = std(GMS)."""
    x = F.avg_pool2d(_lum255(x)[:, None], 2)  # the paper's preprocessing
    y = F.avg_pool2d(_lum255(y)[:, None], 2)
    hx = torch.tensor([[1.0, 0.0, -1.0]] * 3, device=x.device) / 3.0

    def grad_mag(v):
        gx = F.conv2d(v, hx[None, None], padding=1)
        gy = F.conv2d(v, hx.T[None, None], padding=1)
        return torch.sqrt(gx * gx + gy * gy + 1e-12)

    gmx = grad_mag(x)
    gmy = grad_mag(y)
    c = 170.0
    gms = (2.0 * gmx * gmy + c) / (gmx * gmx + gmy * gmy + c)
    return torch.std(gms, dim=(1, 2, 3), correction=0)


# ---------------------------------------------------------------------------
# FSIM / FSIMc (Zhang et al. 2011), a competitor metric in the reference's
# Test2 results table. The phase-congruency transform follows the FSIM
# authors' embedding of Kovesi's phasecong2 (4 log-Gabor scales x 4
# orientations, minWaveLength 6, mult 2, sigmaOnf 0.55, dThetaOnSigma 1.2,
# noise threshold k=2 with the /1.7 empirical rescale). The filters are
# numpy constants; only the image FFTs run on the device.
# ---------------------------------------------------------------------------

_PC_NSCALE = 4
_PC_NORIENT = 4
_PC_MIN_WAVELENGTH = 6.0
_PC_MULT = 2.0
_PC_SIGMA_ONF = 0.55
_PC_DTHETA_ON_SIGMA = 1.2
_PC_K = 2.0
_PC_EPS = 1e-4


@functools.lru_cache(maxsize=_FILTER_CACHE)
def _pc_filters(rows: int, cols: int):
    """(filters[o][s] (H,W) float32, noise constants) for phasecong2."""
    if cols % 2:
        xr = np.arange(-(cols - 1) / 2, (cols - 1) / 2 + 1) / (cols - 1)
    else:
        xr = np.arange(-cols / 2, cols / 2) / cols
    if rows % 2:
        yr = np.arange(-(rows - 1) / 2, (rows - 1) / 2 + 1) / (rows - 1)
    else:
        yr = np.arange(-rows / 2, rows / 2) / rows
    xg, yg = np.meshgrid(xr, yr)
    radius = np.fft.ifftshift(np.sqrt(xg * xg + yg * yg))
    radius[0, 0] = 1.0
    theta = np.fft.ifftshift(np.arctan2(-yg, xg))
    sintheta, costheta = np.sin(theta), np.cos(theta)

    lp = np.fft.ifftshift(  # Kovesi lowpassfilter(cutoff=.45, n=15)
        1.0 / (1.0 + (np.fft.fftshift(radius) / 0.45) ** 30))
    log_gabor = []
    for s in range(_PC_NSCALE):
        fo = 1.0 / (_PC_MIN_WAVELENGTH * _PC_MULT**s)
        g = np.exp(-np.log(radius / fo) ** 2
                   / (2.0 * np.log(_PC_SIGMA_ONF) ** 2)) * lp
        g[0, 0] = 0.0
        log_gabor.append(g)

    theta_sigma = np.pi / _PC_NORIENT / _PC_DTHETA_ON_SIGMA
    spreads = []
    for o in range(_PC_NORIENT):
        angl = o * np.pi / _PC_NORIENT
        ds = sintheta * np.cos(angl) - costheta * np.sin(angl)
        dc = costheta * np.cos(angl) + sintheta * np.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        spreads.append(np.exp(-dtheta**2 / (2.0 * theta_sigma**2)))

    filters = tuple(tuple((log_gabor[s] * spreads[o]).astype(np.float32)
                          for s in range(_PC_NSCALE)) for o in range(_PC_NORIENT))

    # per-orientation noise-model constants (data enters only through the
    # median of the smallest-scale energy)
    noise_const = []
    for o in range(_PC_NORIENT):
        em_n = float(np.sum(filters[o][0] ** 2))
        ifft_filts = [
            np.real(np.fft.ifft2(filters[o][s])) * np.sqrt(rows * cols)
            for s in range(_PC_NSCALE)
        ]
        sum_an2 = float(sum(np.sum(f * f) for f in ifft_filts))
        sum_aiaj = float(sum(
            np.sum(ifft_filts[si] * ifft_filts[sj])
            for si in range(_PC_NSCALE) for sj in range(si + 1, _PC_NSCALE)
        ))
        noise_const.append((em_n, sum_an2, sum_aiaj))
    return filters, tuple(noise_const)


@functools.lru_cache(maxsize=_FILTER_CACHE)
def _pc_filters_on(rows: int, cols: int, device: torch.device) -> torch.Tensor:
    """``_pc_filters``' bank as one (O, S, H, W) float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(_pc_filters(rows, cols)[0]), device=device)


def _median_hw(v: torch.Tensor) -> torch.Tensor:
    """Median over the last two axes of (N, H, W), kept as (N, 1, 1).
    ``jnp.median`` averages the two middle values of an even count, where
    ``torch.median`` returns the lower one."""
    flat = v.reshape(v.shape[0], -1).sort(dim=1).values
    k = flat.shape[1] // 2
    mid = flat[:, k] if flat.shape[1] % 2 else 0.5 * (flat[:, k - 1] + flat[:, k])
    return mid[:, None, None]


def _phase_congruency(im: torch.Tensor) -> torch.Tensor:
    """Kovesi phasecong2 map over an NHW luminance batch (per FSIM.m)."""
    n, rows, cols = im.shape
    _, noise_const = _pc_filters(rows, cols)
    filters = _pc_filters_on(rows, cols, im.device)
    imfft = torch.fft.fft2(im.float())

    energy_all = 0.0
    an_all = 0.0
    for o in range(_PC_NORIENT):
        eos = []
        sum_an = 0.0
        sum_e = 0.0
        sum_o = 0.0
        for s in range(_PC_NSCALE):
            eo = torch.fft.ifft2(imfft * filters[o, s])
            eos.append(eo)
            sum_an = sum_an + eo.abs()
            sum_e = sum_e + eo.real
            sum_o = sum_o + eo.imag
        x_energy = torch.sqrt(sum_e**2 + sum_o**2) + _PC_EPS
        mean_e = sum_e / x_energy
        mean_o = sum_o / x_energy
        energy = 0.0
        for eo in eos:
            e, oi = eo.real, eo.imag
            energy = energy + e * mean_e + oi * mean_o - (e * mean_o - oi * mean_e).abs()

        em_n, sum_an2, sum_aiaj = noise_const[o]
        median_e2n = _median_hw(eos[0].abs() ** 2)
        mean_e2n = median_e2n / float(np.log(2.0))
        noise_power = mean_e2n / em_n
        est_noise_energy2 = (2.0 * noise_power * sum_an2
                             + 4.0 * noise_power * sum_aiaj)
        tau = torch.sqrt(est_noise_energy2 / 2.0)
        est_mean = tau * float(np.sqrt(np.pi / 2.0))
        est_sigma = torch.sqrt(float(2.0 - np.pi / 2.0) * tau**2)
        t = (est_mean + _PC_K * est_sigma) / 1.7  # FSIM.m empirical rescale
        energy = torch.clamp(energy - t, min=0.0)

        energy_all = energy_all + energy
        an_all = an_all + sum_an
    return energy_all / an_all


def _scharr_grad(v: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude with FSIM.m's Scharr/16 operator over NHW."""
    kx = torch.tensor([[3.0, 0.0, -3.0], [10.0, 0.0, -10.0], [3.0, 0.0, -3.0]],
                      device=v.device) / 16.0
    gx = F.conv2d(v[:, None], kx[None, None], padding=1)[:, 0]
    gy = F.conv2d(v[:, None], kx.T[None, None], padding=1)[:, 0]
    return torch.sqrt(gx * gx + gy * gy)


def _fsim_impl(x: torch.Tensor, y: torch.Tensor):
    """Shared FSIM/FSIMc pipeline; returns (fsim, fsimc) per image."""
    x = x.float() * 255.0
    y = y.float() * 255.0

    def yiq(v):
        return (
            0.299 * v[..., 0] + 0.587 * v[..., 1] + 0.114 * v[..., 2],
            0.596 * v[..., 0] - 0.274 * v[..., 1] - 0.322 * v[..., 2],
            0.211 * v[..., 0] - 0.523 * v[..., 1] + 0.312 * v[..., 2],
        )

    y1, i1, q1 = yiq(x)
    y2, i2, q2 = yiq(y)

    rows, cols = y1.shape[1], y1.shape[2]
    # MATLAB round() is half-away-from-zero; Python's round() banker's-
    # rounds .5 boundaries down (640-px min side: F=3 in FSIM.m, not 2)
    f = max(1, int(np.floor(min(rows, cols) / 256.0 + 0.5)))
    if f > 1:
        ave = torch.full((1, 1, f, f), 1.0 / (f * f), device=x.device)
        pad = (f - 1) // 2

        def down(v):
            # 'same' average filter then 1:F subsampling (FSIM.m order)
            vp = F.pad(v[:, None], (pad, f - 1 - pad, pad, f - 1 - pad))
            return F.conv2d(vp, ave)[:, 0, ::f, ::f]

        y1, i1, q1, y2, i2, q2 = (down(v) for v in (y1, i1, q1, y2, i2, q2))

    pc1 = _phase_congruency(y1)
    pc2 = _phase_congruency(y2)
    g1 = _scharr_grad(y1)
    g2 = _scharr_grad(y2)

    t1, t2, t3, t4, lam = 0.85, 160.0, 200.0, 200.0, 0.03
    s_pc = (2.0 * pc1 * pc2 + t1) / (pc1**2 + pc2**2 + t1)
    s_g = (2.0 * g1 * g2 + t2) / (g1**2 + g2**2 + t2)
    pcm = torch.maximum(pc1, pc2)
    sim = s_g * s_pc * pcm
    denom = pcm.sum(dim=(1, 2))
    fsim_val = sim.sum(dim=(1, 2)) / denom

    s_i = (2.0 * i1 * i2 + t3) / (i1**2 + i2**2 + t3)
    s_q = (2.0 * q1 * q2 + t4) / (q1**2 + q2**2 + t4)
    # FSIM.m uses real((S_I*S_Q)^lambda): for negative products MATLAB's
    # complex power yields |s|^lam * cos(lam*pi), not a sign flip
    siq = s_i * s_q
    chroma = siq.abs() ** lam * torch.where(
        siq < 0, torch.full_like(siq, float(np.cos(lam * np.pi))), torch.ones_like(siq))
    fsimc_val = (sim * chroma).sum(dim=(1, 2)) / denom
    return fsim_val, fsimc_val


@_fp32
def fsim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """FSIM (luma) per-image scores over NHWC [0,1] batches."""
    return _fsim_impl(x, y)[0]


@_fp32
def fsimc(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """FSIMc (luma + IQ chrominance) per-image scores."""
    return _fsim_impl(x, y)[1]


# ---------------------------------------------------------------------------
# NLPD (Laparra, Ballé, Berardino & Simoncelli 2016): normalized Laplacian
# pyramid distance. A 6-level Laplacian pyramid (Burt-Adelson a=0.4 five-tap)
# on luminance, each subband divisively normalized by a 3x3 local-amplitude
# filter plus a per-scale sigma (the authors' released DN_filters
# constants), distance = mean over subbands of per-band RMSE. Lower is
# better; 0 for identical inputs.
# ---------------------------------------------------------------------------

_NLPD_LAP_TAPS = np.asarray([0.05, 0.25, 0.4, 0.25, 0.05], np.float32)
_NLPD_SIGMAS = (0.0248, 0.0185, 0.0179, 0.0191, 0.0220, 0.2782)
_NLPD_DN_FILTS = tuple(
    np.asarray([[0.0, a, 0.0], [b, 0.0, c], [0.0, d, 0.0]], np.float32)
    for a, b, c, d in (
        (0.1011, 0.1493, 0.1460, 0.1015),
        (0.0757, 0.1986, 0.1846, 0.0837),
        (0.0477, 0.2138, 0.2243, 0.0467),
        (0.0555, 0.2116, 0.2123, 0.0514),
        (0.0078, 0.2350, 0.2400, 0.0328),
        (0.0018, 0.2520, 0.2541, 0.0004),
    )
)


def _nlpd_conv(x: torch.Tensor, k2d, pad: int, stride: int = 1) -> torch.Tensor:
    """Reflect-padded dense 2-D correlation over an NHW batch."""
    xp = F.pad(x[:, None], (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(xp, _t(k2d, x)[None, None], stride=stride)[:, 0]


def _nlpd_up(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Zero-stuffed 2x upsample + 4*filt interpolation (NHW), cropped to
    (out_h, out_w) so odd parent sizes round-trip."""
    k = np.outer(_NLPD_LAP_TAPS, _NLPD_LAP_TAPS) * 4.0
    n, h, w = x.shape
    z = x.new_zeros((n, 1, 2 * h - 1, 2 * w - 1))
    z[:, 0, ::2, ::2] = x
    y = F.conv2d(F.pad(z, (2, 3, 2, 3)), _t(k, x)[None, None])[:, 0]
    return y[:, :out_h, :out_w]


def _nlpd_pyramid(im: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Normalized Laplacian subbands of an NHW luminance batch."""
    lap_k = np.outer(_NLPD_LAP_TAPS, _NLPD_LAP_TAPS)
    bands = []
    for i in range(levels - 1):
        down = _nlpd_conv(im, lap_k, pad=2, stride=2)
        up = _nlpd_up(down, im.shape[1], im.shape[2])
        lap = im - up
        den = _nlpd_conv(lap.abs(), _NLPD_DN_FILTS[i], pad=1)
        bands.append(lap / (den + _NLPD_SIGMAS[i]))
        im = down
    den = _nlpd_conv(im.abs(), _NLPD_DN_FILTS[levels - 1], pad=1)
    bands.append(im / (den + _NLPD_SIGMAS[levels - 1]))
    return bands


def nlpd_max_levels(h: int, w: int, cap: int = 6) -> int:
    """Deepest NLPD pyramid the (h, w) frame supports: min side must stay
    >= 3 at every level for the 5-tap reflect pad (callers with variable
    frame sizes, prep_fr's aspect/full_size policies, clamp with this)."""
    return max(1, min(cap, int(math.floor(math.log2(min(h, w) / 3.0))) + 1))


@_fp32
def nlpd(x: torch.Tensor, y: torch.Tensor, levels: int = 6) -> torch.Tensor:
    """Per-image NLPD over NHWC [0,1] batches (lower is better). Needs min
    side >= 3 * 2^(levels-1) so the deepest level still fits the 5-tap
    reflect pad; pass a smaller ``levels`` for tiny images
    (``nlpd_max_levels``)."""
    p1 = _nlpd_pyramid(_lum255(x) / 255.0, levels)
    p2 = _nlpd_pyramid(_lum255(y) / 255.0, levels)
    dist = 0.0
    for a, b in zip(p1, p2):
        dist = dist + torch.sqrt((a - b).square().mean(dim=(1, 2)) + 1e-12)
    return dist / float(levels)


# ---------------------------------------------------------------------------
# MAD (Larson & Chandler 2010, "Most apparent distortion"). Two strategies
# combined adaptively:
#   * detection (hi-quality) index: perceived luminance (k*I)^(2.2/3),
#     Mannos–Sakrison-style CSF in the frequency domain, then visible local
#     MSE gated by an RMS-contrast masking model over 16x16 blocks (stride
#     4; reference block std = min of the four 8x8 sub-block stds);
#   * appearance (lo-quality) index: a 5-scale x 4-orientation log-Gabor
#     decomposition (Kovesi gaborconvolve constants: minWaveLength 3, mult
#     3, sigmaOnf 0.55, dThetaOnSigma 1.5) whose magnitudes are compared by
#     blockwise std/skewness/kurtosis differences with scale weights
#     [0.5 0.75 1 5 6]/13.25.
# Final score = d_detect^a * d_appear^(1-a), a = 1/(1 + b1*d_detect^b2),
# b1=0.467, b2=0.130. 0 for identical images; higher = worse quality. Block
# maps use VALID windows (no boundary blocks).
# ---------------------------------------------------------------------------

_MAD_BLOCK = 16
_MAD_STRIDE = 4
_MAD_BETA1 = 0.467
_MAD_BETA2 = 0.130
_MAD_GABOR_WEIGHTS = np.asarray([0.5, 0.75, 1.0, 5.0, 6.0], np.float32)
_MAD_GABOR_WEIGHTS /= _MAD_GABOR_WEIGHTS.sum()


def _mad_csf(rows: int, cols: int) -> np.ndarray:
    """Frequency-domain CSF (ifftshift layout): Mannos–Sakrison curve with
    the oblique effect, 32 cycles/degree across the image, and the
    original's low-frequency plateau 0.9809 below 7.8909 cyc/deg."""
    nfreq = 32.0
    u = np.arange(-(cols - 1) / 2.0, (cols + 1) / 2.0) / cols * 2 * nfreq
    v = np.arange(-(rows - 1) / 2.0, (rows + 1) / 2.0) / rows * 2 * nfreq
    ug, vg = np.meshgrid(u, v)
    radfreq = np.sqrt(ug * ug + vg * vg)
    w = 0.7
    s = (1 - w) / 2 * np.cos(4 * np.arctan2(vg, ug)) + (1 + w) / 2
    radfreq = radfreq / s
    csf = 2.6 * (0.0192 + 0.114 * radfreq) * np.exp(-((0.114 * radfreq) ** 1.1))
    csf[radfreq < 7.8909] = 0.9809
    return np.fft.ifftshift(csf).astype(np.float32)


def _mad_window_mean(v: torch.Tensor, block: int, stride: int) -> torch.Tensor:
    """Blockwise mean over an NHW batch (VALID windows)."""
    return F.avg_pool2d(v[:, None], block, stride)[:, 0]


def _mad_window_std(v: torch.Tensor, block: int, stride: int) -> torch.Tensor:
    """Blockwise std, its moments in float64 (see ``_mad_block_stats``)."""
    v64 = v.double()
    m1 = _mad_window_mean(v64, block, stride)
    m2 = _mad_window_mean(v64 * v64, block, stride)
    return torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0)).to(v.dtype)


def _mad_min_subblock_std(v: torch.Tensor) -> torch.Tensor:
    """Per 16x16 stride-4 block: min std over its four 8x8 sub-blocks."""
    s8 = _mad_window_std(v, _MAD_BLOCK // 2, _MAD_STRIDE)
    # 16x16 block at window index q covers 8x8 windows {q, q+2}^2
    n, h8, w8 = s8.shape
    h16, w16 = h8 - 2, w8 - 2
    out = s8[:, :h16, :w16]
    for di, dj in ((0, 2), (2, 0), (2, 2)):
        out = torch.minimum(out, s8[:, di:di + h16, dj:dj + w16])
    return out


def _mad_detect(ref_lum: torch.Tensor, dst_lum: torch.Tensor) -> torch.Tensor:
    """Detection-stage index over NHW [0,255] luminance batches."""
    k = 0.02874
    g_thr = 0.5
    c_slope, ci_thr, cd_thr = 1.0, -5.0, -5.0
    n, rows, cols = ref_lum.shape
    csf = _mad_filters_on(rows, cols, ref_lum.device)[0]

    def perceived(v):
        lum = (k * torch.clamp(v, min=0.0) + 1e-12) ** (2.2 / 3.0)
        return torch.fft.ifft2(torch.fft.fft2(lum) * csf).real

    ref = perceived(ref_lum)
    dst = perceived(dst_lum)
    err = ref - dst

    mean_ref = _mad_window_mean(ref, _MAD_BLOCK, _MAD_STRIDE)
    std_err = _mad_window_std(err, _MAD_BLOCK, _MAD_STRIDE)
    std_ref = _mad_min_subblock_std(ref)

    lit = mean_ref > g_thr
    safe_mean = torch.where(lit, mean_ref, torch.ones_like(mean_ref))
    off = torch.full_like(mean_ref, -999.0)
    ci_ref = torch.where(lit, torch.log(torch.clamp(std_ref, min=1e-12) / safe_mean), off)
    ci_err = torch.where(lit, torch.log(torch.clamp(std_err, min=1e-12) / safe_mean), off)

    msk = torch.where(
        ci_ref > ci_thr,
        torch.clamp(ci_err - (c_slope * (ci_ref - ci_thr) + cd_thr), min=0.0),
        torch.clamp(ci_err - ci_thr, min=0.0),
    )
    lmse = _mad_window_mean(err * err, _MAD_BLOCK, _MAD_STRIDE)
    mp = msk * lmse
    return torch.sqrt(mp.square().mean(dim=(1, 2)) + 1e-24) * 200.0


def _mad_gabor_filters(rows: int, cols: int) -> list[list[np.ndarray]]:
    """Kovesi gaborconvolve log-Gabor bank (ifftshift layout), 5 scales x 4
    orientations, minWaveLength 3, mult 3, sigmaOnf 0.55, dThetaOnSigma
    1.5."""
    nscale, norient = 5, 4
    min_wl, mult, sigma_onf, dtheta_on_sigma = 3.0, 3.0, 0.55, 1.5
    if cols % 2:
        xr = np.arange(-(cols - 1) / 2, (cols - 1) / 2 + 1) / (cols - 1)
    else:
        xr = np.arange(-cols / 2, cols / 2) / cols
    if rows % 2:
        yr = np.arange(-(rows - 1) / 2, (rows - 1) / 2 + 1) / (rows - 1)
    else:
        yr = np.arange(-rows / 2, rows / 2) / rows
    xg, yg = np.meshgrid(xr, yr)
    radius = np.fft.ifftshift(np.sqrt(xg * xg + yg * yg))
    radius[0, 0] = 1.0
    theta = np.fft.ifftshift(np.arctan2(-yg, xg))
    sintheta, costheta = np.sin(theta), np.cos(theta)
    theta_sigma = np.pi / norient / dtheta_on_sigma

    radial = []
    for s in range(nscale):
        fo = 1.0 / (min_wl * mult**s)
        g = np.exp(-np.log(radius / fo) ** 2 / (2.0 * np.log(sigma_onf) ** 2))
        g[0, 0] = 0.0
        radial.append(g)
    banks = []
    for o in range(norient):
        angl = o * np.pi / norient
        ds = sintheta * np.cos(angl) - costheta * np.sin(angl)
        dc = costheta * np.cos(angl) + sintheta * np.sin(angl)
        spread = np.exp(-np.arctan2(np.abs(ds), dc) ** 2
                        / (2.0 * theta_sigma**2))
        banks.append([(radial[s] * spread).astype(np.float32)
                      for s in range(nscale)])
    return banks


@functools.lru_cache(maxsize=_FILTER_CACHE)
def _mad_filters_on(rows: int, cols: int, device: torch.device):
    """(CSF (H, W), log-Gabor bank (O, S, H, W)), float32 on ``device``."""
    return (torch.as_tensor(_mad_csf(rows, cols), device=device),
            torch.as_tensor(np.asarray(_mad_gabor_filters(rows, cols)), device=device))


def _mad_block_stats(v: torch.Tensor):
    """Blockwise (16x16 stride 4) std, skewness, kurtosis of an NHW batch.
    The image's global mean is subtracted first (central moments are
    shift-invariant), and the raw moments are summed and combined in
    float64: a block whose variance is a thousandth of its raw second
    moment leaves the float32 kurtosis a few digits, and CUDA's float32
    pools sum in float32 where the CPU's sum in double (with float32 block
    moments, MAD on an H100 was 8.7 % from the CPU's on a textured
    176 x 184 pair). The JAX module keeps them in float32."""
    dtype = v.dtype
    v = v.double()
    v = v - v.mean(dim=(1, 2), keepdim=True)
    m1 = _mad_window_mean(v, _MAD_BLOCK, _MAD_STRIDE)
    m2 = _mad_window_mean(v * v, _MAD_BLOCK, _MAD_STRIDE)
    m3 = _mad_window_mean(v * v * v, _MAD_BLOCK, _MAD_STRIDE)
    m4 = _mad_window_mean(v * v * v * v, _MAD_BLOCK, _MAD_STRIDE)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    m3c = m3 - 3.0 * m1 * m2 + 2.0 * m1**3
    m4c = m4 - 4.0 * m1 * m3 + 6.0 * m1 * m1 * m2 - 3.0 * m1**4
    ok = var > 1e-12
    safe = torch.where(ok, var, torch.ones_like(var))
    std = torch.sqrt(var)
    zero = torch.zeros_like(var)
    skw = torch.where(ok, m3c / safe**1.5, zero)
    krt = torch.where(ok, m4c / (safe * safe), zero)
    return std.to(dtype), skw.to(dtype), krt.to(dtype)


def _mad_appear(ref_lum: torch.Tensor, dst_lum: torch.Tensor) -> torch.Tensor:
    """Appearance-stage index over NHW [0,255] luminance batches."""
    n, rows, cols = ref_lum.shape
    banks = _mad_filters_on(rows, cols, ref_lum.device)[1]
    fref = torch.fft.fft2(ref_lum)
    fdst = torch.fft.fft2(dst_lum)
    eta = 0.0
    for bank in banks:
        for s, filt in enumerate(bank):
            mag_r = torch.fft.ifft2(fref * filt).abs()
            mag_d = torch.fft.ifft2(fdst * filt).abs()
            std_r, skw_r, krt_r = _mad_block_stats(mag_r)
            std_d, skw_d, krt_d = _mad_block_stats(mag_d)
            eta = eta + float(_MAD_GABOR_WEIGHTS[s]) * (
                (std_r - std_d).abs() + 2.0 * (skw_r - skw_d).abs()
                + (krt_r - krt_d).abs())
    return torch.sqrt(eta.square().mean(dim=(1, 2)) + 1e-24)


@_fp32
def mad(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-image MAD over NHWC [0,1] batches; ``x`` is the reference.
    Higher is worse; 0 for identical inputs. Needs min side >= 16."""
    ref = _lum255(x)
    dst = _lum255(y)
    d_detect = _mad_detect(ref, dst)
    d_appear = _mad_appear(ref, dst)
    alpha = 1.0 / (1.0 + _MAD_BETA1 * torch.clamp(d_detect, min=1e-12) ** _MAD_BETA2)
    return (torch.clamp(d_detect, min=0.0) ** alpha
            * torch.clamp(d_appear, min=0.0) ** (1.0 - alpha))
