"""ADISTS — adaptive DISTS with per-pixel structure/texture weighting.

Counterpart of ``nerf_qa_tpu/core/adists.py``. Reference behaviour:
nerf_qa/ADISTS/ADISTS.py:34-197. Same VGG16 + L2-pool pyramid as DISTS,
then:

1. ``compute_prob`` (:71-100): per stage (coarse -> fine), windowed
   variance/mean ratio γ; ps = sigmoid((γ − mean γ) / std γ); min/max
   renormalised; multiplied with the bilinear-upsampled coarser product and
   renormalised again. Stages too small for the window use global stats
   and plain sigmoid(γ).
2. Entropy channel weights (:127-135): spatially L2-normalised ReLU
   features -> per-channel Shannon entropy -> normalised, then clamped to
   mean ± 0.5·std and renormalised (:152-160).
3. Per-stage windowed T (texture) and S (structure) maps of the spatially
   L2-normalised features (:168-183), blended D = Σ (pt·T + ps·S)·w
   (:182-191): the fused CUDA kernel ``ops/cuda/windowed_tsd.py`` on CUDA
   tensors (``fused_tsd=True``, the default), its plain version otherwise.

Outputs: scalar loss 1 − mean(D) (as_loss), per-image 1 − D, or a
full-resolution distortion map 1 − Σ upsampled D maps (as_map).

The L2 normalisation is a per-(image, channel) scale, so the T/S map takes
the raw features and the inverse norms and scales the windowed moments.
The JAX package's ``_stage_moments_blocked`` (one scan sharing five
windowed moments between γ and T/S, a TPU pass-count optimisation) has no
counterpart: at full resolution γ comes from ``windowed_gamma_sum`` (the
γ kernel ``ops/cuda/windowed_gamma.py`` on CUDA tensors, a loop over
channel blocks otherwise) and the T/S map from the kernel (its plain
version loops over channel blocks).

The statistics run in true fp32 (no TF32): var = W(f²) − W(f)² cancels.

Spans (``utils/profiling.span``): ``adists.forward`` around the call,
``adists.weights`` around the entropy weights, and per stage
``adists.norms`` (the inverse L2 norms), ``adists.ps:<n>:<h>:<w>:<c>`` (γ
and the cascade step, in either branch; inside it, on the card,
``adists.gamma:<n>:<h>:<w>:<c>:<itemsize>`` around the γ kernel),
``adists.tsd:<n>:<h>:<w>:<c>:<itemsize>`` (the windowed T/S map) or
``adists.global`` (a stage smaller than the window).
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from nerf_qa_torch.config import ADISTSConfig, torch_dtype, true_fp32
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.ops.cuda import windowed_gamma
from nerf_qa_torch.ops.cuda.windowed_tsd import windowed_tsd, windowed_tsd_plain
from nerf_qa_torch.ops.resize import resize_bilinear
from nerf_qa_torch.ops.windowed import fits_window, window_mean
from nerf_qa_torch.utils.profiling import span

_C0 = 1e-12
_EPS = 1e-6


def _resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear NHWC resize with align_corners=True (ADISTS.py:87); an
    output of size 1 takes index 0."""
    return resize_bilinear(x.float(), out_h, out_w, align_corners=True)


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-image spatial min/max renormalisation (ADISTS.py:84-90)."""
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    return (x - mn) / (mx - mn + _C0)


def windowed_gamma_sum(f: torch.Tensor, window_size: int, block: int) -> torch.Tensor:
    """Windowed var/mean ratio SUM over channels, (N, H, W, C) ->
    (N, Hk, Wk, 1) fp32. Callers divide by the channel count.

    CPU tensors, and calls where autograd would record ``f``, take the
    plain loop (``ops/cuda/windowed_gamma.windowed_gamma_sum_plain``:
    ``block`` channels of VALID moment maps live at a time). CUDA tensors
    otherwise launch the kernel in the span ``adists.gamma:<n>:<h>:<w>:
    <c>:<itemsize>``; it keeps the moment maps on chip, so ``block`` has no
    effect there. Any other device raises."""
    if f.device.type == "cpu" or (torch.is_grad_enabled() and f.requires_grad):
        return windowed_gamma.windowed_gamma_sum_plain(f, window_size, block)
    with span("adists.gamma", lambda: (*f.shape, f.element_size())):
        return windowed_gamma.windowed_gamma_sum(f, window_size)


def _stage_gamma(f: torch.Tensor, window_size: int, block_pixels: int,
                 channel_block: int) -> torch.Tensor:
    """γ of a stage that fits the window, (N, Hk, Wk, 1): the channel mean
    of windowed var/mean, channel-blocked above ``block_pixels``."""
    n, h, w, c = f.shape
    if h * w > block_pixels:
        return windowed_gamma_sum(f, window_size, channel_block) / c
    f = f.float()
    mean = window_mean(f, window_size)
    var = window_mean(f * f, window_size) - mean.square()
    return (var / (mean + _C0)).mean(dim=-1, keepdim=True)


def _prob_update(gamma: torch.Tensor, ps_prod: torch.Tensor,
                 fits: bool) -> torch.Tensor:
    """One coarse->fine step of the ps cascade (ADISTS.py:78-97): the new
    running product, which is the stage's ps map. Stages too small for
    the window (``fits=False``) use plain sigmoid(γ), times the running
    product's top-left value, with no renormalisation."""
    if fits:
        g_mean = gamma.mean(dim=(1, 2), keepdim=True)
        # torch .std() default is unbiased (ddof=1), ADISTS.py:83
        g_std = gamma.std(dim=(1, 2), keepdim=True)
        ps = _minmax_norm(torch.sigmoid((gamma - g_mean) / (g_std + _C0)))
        hk, wk = ps.shape[1], ps.shape[2]
        return _minmax_norm(ps * _resize_align_corners(ps_prod, hk, wk))
    return torch.sigmoid(gamma) * _resize_align_corners(ps_prod, 1, 1)


def compute_prob(feats: Sequence[torch.Tensor], window_size: int = 21,
                 block_pixels: int = 448 * 448,
                 channel_block: int = 16) -> list[torch.Tensor]:
    """Per-stage structure probability maps ps (ADISTS.py:71-100),
    cascaded coarse -> fine: one (N, Hk, Wk, 1) map per stage."""
    ps_list: list[torch.Tensor] = []
    ps_prod = torch.ones(tuple(feats[0].shape[:3]) + (1,), dtype=torch.float32,
                         device=feats[0].device)
    with true_fp32():
        for k in range(len(feats) - 1, -1, -1):
            f = feats[k].float()
            fits = fits_window(f.shape[1], f.shape[2], window_size)
            if fits:
                gamma = _stage_gamma(f, window_size, block_pixels, channel_block)
            else:
                x_mean = f.mean(dim=(1, 2), keepdim=True)
                x_var = (f - x_mean).square().mean(dim=(1, 2), keepdim=True)
                gamma = (x_var / (x_mean + _C0)).mean(dim=-1, keepdim=True)
            ps_prod = _prob_update(gamma, ps_prod, fits)
            ps_list.append(ps_prod)
    return ps_list[::-1]


def _spatial_l2_normalize(f: torch.Tensor) -> torch.Tensor:
    """F.normalize(..., dim=(2, 3)) over NCHW: per-(image, channel) L2 over
    the spatial plane (ADISTS.py:166-167)."""
    norm = f.square().sum(dim=(1, 2), keepdim=True).sqrt()
    return f / norm.clamp_min(1e-12)


def _inv_l2_norm(f: torch.Tensor) -> torch.Tensor:
    """Inverse spatial L2 norms (N, C) of NHWC features, fp32."""
    f = f.float()
    return 1.0 / f.square().sum(dim=(1, 2)).sqrt().clamp_min(1e-12)


def channel_entropy(f: torch.Tensor) -> torch.Tensor:
    """Raw per-channel Shannon entropies (bits), (N, H, W, C) -> (N, C):
    spatially L2-normalised ReLU features -> distribution over pixels ->
    entropy (ADISTS.py:127-133). All-zero channels yield 0."""
    f = _spatial_l2_normalize(torch.relu(f.float()))
    n, h, w, c = f.shape
    flat = f.reshape(n, h * w, c)
    flat = flat / (flat.sum(dim=1, keepdim=True) + _C0)
    return (-flat * torch.log2(flat + _C0)).sum(dim=1)


def entropy_weights(f: torch.Tensor) -> torch.Tensor:
    """Per-channel entropy weights (ADISTS.py:127-135): raw entropies,
    per-image channel-normalised, scaled by C."""
    ent = channel_entropy(f)
    ent = ent / (ent.sum(dim=1, keepdim=True) + _C0)
    return ent * f.shape[-1]


def channel_weights(feats_x: Sequence[torch.Tensor]) -> torch.Tensor:
    """The (N, 1475) entropy channel weights of the whole pyramid, clamped
    to mean ± 0.5·std (the population std) and renormalised
    (ADISTS.py:152-160)."""
    weight = torch.cat([entropy_weights(f) for f in feats_x], dim=1)
    weight = weight / weight.sum(dim=1, keepdim=True)
    w_mean = weight.mean(dim=1, keepdim=True)
    w_std = (weight - w_mean).square().mean(dim=1, keepdim=True).sqrt()
    weight = torch.clamp(weight, w_mean - 0.5 * w_std, w_mean + 0.5 * w_std)
    return weight / weight.sum(dim=1, keepdim=True)


def _global_stage(f: torch.Tensor, g: torch.Tensor, inv_x: torch.Tensor,
                  inv_y: torch.Tensor, w_k: torch.Tensor,
                  ps_prod: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A stage smaller than the window: global moments, the ps step and the
    blended T/S sum. Returns the (N, 1, 1) distortion map and the new
    running product."""
    f = f.float()
    g = g.float()
    mf = f.mean(dim=(1, 2), keepdim=True)
    mg = g.mean(dim=(1, 2), keepdim=True)
    vf = (f - mf).square().mean(dim=(1, 2), keepdim=True)
    vg = (g - mg).square().mean(dim=(1, 2), keepdim=True)
    cov = (f * g).mean(dim=(1, 2), keepdim=True) - mf * mg
    with span("adists.ps", lambda: f.shape):
        gamma = (vf / (mf + _C0)).mean(dim=-1, keepdim=True)
        ps = _prob_update(gamma, ps_prod, False)
    ix = inv_x[:, None, None, :]
    iy = inv_y[:, None, None, :]
    x_mean, y_mean = ix * mf, iy * mg
    t = (2 * x_mean * y_mean + _EPS) / (x_mean.square() + y_mean.square() + _EPS)
    s = (2 * (ix * iy * cov) + _EPS) / (ix.square() * vf + iy.square() * vg + _EPS)
    d = (((1.0 - ps) * t + ps * s) * w_k[:, None, None, :]).sum(dim=-1)
    return d, ps


def forward(
    model: VGG16Pyramid,
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: ADISTSConfig = ADISTSConfig(),
    as_loss: bool = True,
    as_map: bool = False,
) -> torch.Tensor:
    """ADISTS forward on NHWC batches in [0, 1] (ADISTS.py:137-197).
    Entropy weights and γ come from ``x`` only: the metric is asymmetric.
    Runs in the span ``adists.forward``."""
    with span("adists.forward"):
        return _forward(model, x, y, cfg, as_loss, as_map)


def _forward(model: VGG16Pyramid, x: torch.Tensor, y: torch.Tensor,
             cfg: ADISTSConfig, as_loss: bool, as_map: bool) -> torch.Tensor:
    if x.shape != y.shape:
        raise ValueError(
            f"ADISTS requires identically shaped inputs, got {tuple(x.shape)} "
            f"vs {tuple(y.shape)}"
        )
    n, big_h, big_w = x.shape[0], x.shape[1], x.shape[2]
    both = model(torch.cat([x, y]), torch_dtype(cfg.compute_dtype))
    feats_x = [f[:n] for f in both]
    feats_y = [f[n:] for f in both]
    ws = cfg.window_size
    tsd = (windowed_tsd if cfg.fused_tsd else
           functools.partial(windowed_tsd_plain, channel_block=cfg.channel_block))

    with true_fp32():
        with span("adists.weights"):
            weight = channel_weights(feats_x)
        offsets = [0]
        for f in feats_x:
            offsets.append(offsets[-1] + f.shape[-1])

        d_total = torch.zeros((n,), dtype=torch.float32, device=x.device)
        d_map_full = (torch.zeros((n, big_h, big_w), dtype=torch.float32,
                                  device=x.device) if as_map else None)
        ps_prod = torch.ones((n, *feats_x[0].shape[1:3], 1), dtype=torch.float32,
                             device=x.device)
        for k in range(len(feats_x) - 1, -1, -1):
            f_raw, g_raw = feats_x[k], feats_y[k]
            h, w = f_raw.shape[1], f_raw.shape[2]
            w_k = weight[:, offsets[k]:offsets[k + 1]]
            with span("adists.norms"):
                inv_x, inv_y = _inv_l2_norm(f_raw), _inv_l2_norm(g_raw)
            if fits_window(h, w, ws):
                with span("adists.ps", lambda: f_raw.shape):
                    gamma = _stage_gamma(f_raw, ws, cfg.block_pixels_threshold,
                                         cfg.channel_block)
                    ps_prod = _prob_update(gamma, ps_prod, True)
                with span("adists.tsd", lambda: (*f_raw.shape, f_raw.element_size())):
                    d_map = tsd(f_raw, g_raw, ps_prod, w_k, ws, inv_x=inv_x,
                                inv_y=inv_y)
            else:
                with span("adists.global"):
                    d_map, ps_prod = _global_stage(f_raw, g_raw, inv_x, inv_y,
                                                   w_k, ps_prod)
            if as_map:
                d_map_full += resize_bilinear(d_map[..., None], big_h, big_w)[..., 0]
            d_total += d_map.mean(dim=(1, 2))

    if as_map:
        return 1.0 - d_map_full
    if as_loss:
        return 1.0 - d_total.mean()
    return 1.0 - d_total


def forward_once(model: VGG16Pyramid, x: torch.Tensor,
                 cfg: ADISTSConfig = ADISTSConfig()) -> list[torch.Tensor]:
    """Feature pyramid (ADISTS.py:112-125); identical to the DISTS one."""
    return model(x, torch_dtype(cfg.compute_dtype))
