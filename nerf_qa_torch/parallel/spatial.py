"""Spatial (H-axis) sharded full-resolution DISTS and ADISTS scoring.

Counterpart of ``nerf_qa_tpu/parallel/spatial.py``. The reference scores
full-size 1080p frames on one GPU (test2_prep.py:199-313, the full_size
policy). This module splits each frame's HEIGHT over the mesh's ``model``
axis (the batch over its ``data`` axis), one slab a device:

* every 3x3 VGG conv takes one halo row from each H-neighbour's slab (a
  ``.to(device)`` copy; slabs at the global edges get zeros, which is
  exactly the SAME padding), then convolves VALID over H;
* the stride-2 L2 pools take a single top halo row: slab heights stay
  even at every pooled level, so no pooling window reaches further;
* DISTS: each slab's five moment sums per stage and channel come from the
  moments kernel (``ops/cuda/moments.moment_sums``; its plain version on
  CPU tensors), and one sum over the slabs on the model axis's first
  device gives the global moments (the JAX ``psum``), in the single-pass
  E[x²] − E[x]² form, which composes across slabs;
* ADISTS: after the pyramid, each device gathers one block of every
  stage's channels from all slabs, at full height (the JAX
  ``all_to_all``); the entropy weights, γ, and the windowed T/S maps are
  separable over channels, so each block computes its part and the
  channel sums add the blocks' parts; the ps cascade runs on the first
  device of the model axis.

Constraints: H must divide by (model axis size · 16) and W by 16, so
every pyramid level splits evenly (pad 1080 to 1088). Slabs are the only
H cuts: every feature map of a slab is made on its device and is
contiguous NHWC, as the moments and T/S kernels require. Scoring only:
the windowed T/S kernel has no backward. The caller places the pyramid on
every device of the mesh once (``parallel.mesh.replicate``) and passes
those copies to every call.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from nerf_qa_torch.config import ADISTSConfig, DISTSConfig, torch_dtype, true_fp32
from nerf_qa_torch.core import dists
from nerf_qa_torch.core.adists import (
    _C0,
    _EPS,
    _inv_l2_norm,
    _prob_update,
    channel_entropy,
    windowed_gamma_sum,
)
from nerf_qa_torch.core.vgg import _CL, L2Pool, VGG16Pyramid, _nchw, _precision
from nerf_qa_torch.ops.cuda.moments import moment_sums, stats_from_sums
from nerf_qa_torch.ops.cuda.windowed_tsd import windowed_tsd, windowed_tsd_plain
from nerf_qa_torch.ops.resize import resize_bilinear
from nerf_qa_torch.ops.windowed import fits_window
from nerf_qa_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    data_sharding,
    to_device,
)


def _check_aligned(hh: int, ww: int, nd: int, what: str) -> None:
    if hh % (nd * 16) or ww % 16:
        raise ValueError(
            f"spatial {what} needs H % {nd * 16} == 0 and W % 16 == 0, "
            f"got {hh}x{ww} (pad the frames, e.g. 1080 -> 1088)")


def shard_frames_spatial(mesh: Mesh, batch) -> list[list]:
    """NHWC frames split over (data, model): for each data shard, one
    H-slab of ``batch`` (a tensor or a tuple / list of equal-shaped ones)
    per device of its mesh row, contiguous on that device."""
    single = torch.is_tensor(batch)
    arrays = [batch] if single else list(batch)
    nd = mesh.shape[MODEL_AXIS]
    hs = arrays[0].shape[1] // nd
    rows = []
    for rows_sl, devs in zip(data_sharding(mesh, arrays[0].shape[0]), mesh.devices):
        slabs = []
        for s, dev in enumerate(devs):
            part = [to_device(a[rows_sl, s * hs:(s + 1) * hs], dev).contiguous()
                    for a in arrays]
            slabs.append(part[0] if single else type(batch)(part))
        rows.append(slabs)
    return rows


def _halo(hs: list[torch.Tensor], bottom: bool) -> list[torch.Tensor]:
    """Each NCHW slab with its upper neighbour's last row on top and, with
    ``bottom``, its lower neighbour's first row below (zeros at the global
    edges)."""
    nd = len(hs)
    out = []
    for i, h in enumerate(hs):
        zero = torch.zeros_like(h[:, :, :1])
        parts = [hs[i - 1][:, :, -1:].to(h.device) if i > 0 else zero, h]
        if bottom:
            parts.append(hs[i + 1][:, :, :1].to(h.device) if i < nd - 1 else zero)
        out.append(torch.cat(parts, dim=2))
    return out


def _conv_relu_spatial(hs, convs, dtype) -> list[torch.Tensor]:
    """3x3 SAME conv + bias + ReLU in ``dtype`` with H halos (VALID over
    the haloed H); one slab is the single-device ``vgg._conv_relu``."""
    hs = [h.to(dtype) for h in hs]
    pad = (1, 1)
    if len(hs) > 1:
        hs, pad = _halo(hs, bottom=True), (0, 1)
    return [F.conv2d(h, c.weight.to(dtype), padding=pad)
            .add_(c.bias.to(dtype).view(1, -1, 1, 1)).relu_()
            for h, c in zip(hs, convs)]


def _l2pool_spatial(hs, pools) -> list[torch.Tensor]:
    """The L2 pool (3x3 Hann², stride 2, pad 1) in the flow dtype with a
    single top halo row of the squares; one slab is ``l2pool_nchw``."""
    sq = [h * h for h in hs]
    pad = (1, 1)
    if len(hs) > 1:
        sq, pad = _halo(sq, bottom=False), (0, 1)
    return [F.conv2d(s, p.filter.to(s.dtype), stride=2, padding=pad,
                     groups=s.shape[1]).add_(1e-12).sqrt_()
            for s, p in zip(sq, pools)]


def _pyramid_spatial(models: list[VGG16Pyramid], slabs: list[torch.Tensor],
                     dtype: torch.dtype) -> list[list[torch.Tensor]]:
    """``VGG16Pyramid.forward`` over H-slabs (slab i on models[i]'s
    device): per slab, the six NHWC levels ``[x, relu1_2, .., relu5_3]``
    in ``dtype``, each contiguous."""
    feats = [[s.to(dtype).contiguous()] for s in slabs]
    hs = [(_nchw(s.float()) - m.mean) / m.std for s, m in zip(slabs, models)]
    with _precision(dtype):
        for si in range(1, 6):
            for layers in zip(*(m.stage(si).children() for m in models)):
                if isinstance(layers[0], L2Pool):
                    hs = _l2pool_spatial(hs, layers)
                else:
                    hs = _conv_relu_spatial(hs, layers, dtype)
            hs = [h.contiguous(memory_format=_CL) for h in hs]
            for f, h in zip(feats, hs):
                f.append(h.permute(0, 2, 3, 1))
    return feats


def _row_pyramid(mesh: Mesh, models: dict, row: int, slabs,
                 dtype: torch.dtype) -> list[list[torch.Tensor]]:
    """One pyramid over concat([x, y]) per slab of a data shard (half the
    work of two pyramid calls' launches, as in the JAX module)."""
    devs = mesh.devices[row]
    return _pyramid_spatial([models[d] for d in devs],
                            [torch.cat([xs, ys]) for xs, ys in slabs], dtype)


def spatial_dists_forward(models: dict[torch.device, VGG16Pyramid],
                          weights: dists.DISTSWeights, x: torch.Tensor,
                          y: torch.Tensor, mesh: Mesh,
                          cfg: DISTSConfig = DISTSConfig()) -> torch.Tensor:
    """Full-resolution DISTS pair scores of NHWC batches in [0, 1], H split
    over the mesh's model axis and the batch over its data axis; (N,)
    scores on the mesh's first device. ``models`` holds the pyramid on
    every device of the mesh (``replicate(mesh, model)``, made once). Each
    slab launches the moments kernel once per stage (six a slab) on CUDA
    tensors."""
    nd = mesh.shape[MODEL_AXIS]
    n, hh, ww, _ = x.shape
    _check_aligned(hh, ww, nd, "sharding")
    dtype = torch_dtype(cfg.compute_dtype)
    # global per-level pixel counts: level k is 2^max(k-1, 0) times smaller
    counts = [(hh >> max(k - 1, 0)) * (ww >> max(k - 1, 0)) for k in range(6)]
    scores = []
    for r, slabs in enumerate(shard_frames_spatial(mesh, (x, y))):
        nl = slabs[0][0].shape[0]
        feats = _row_pyramid(mesh, models, r, slabs, dtype)
        dev0 = mesh.devices[r][0]
        levels = []
        for k in range(6):
            total = None
            for f in feats:
                part = moment_sums(f[k][:nl], f[k][nl:]).to(dev0)
                total = part if total is None else total + part
            levels.append(stats_from_sums(total, counts[k]))
        stats = torch.stack([torch.cat([s[i] for s in levels], dim=-1)
                             for i in range(5)])
        score = dists.score_from_stats(stats, weights.to(dev0), cfg)
        scores.append(score.to(mesh.primary))
    return torch.cat(scores)


def _channel_blocks(feats, k: int, nd: int, devs) -> tuple[list, torch.Tensor, int]:
    """Level ``k``'s channels in ``nd`` blocks of ceil(C / nd), block b on
    ``devs[b]`` at full height (each slab's share of the block gathered
    and concatenated over H), zero-padded to the block width; and the
    (nd · cb,) mask of real channels (JAX ``_channel_block_spec``)."""
    c = feats[0][k].shape[-1]
    cb = -(-c // nd)
    blocks = []
    for b, dev in enumerate(devs):
        lo, hi = min(b * cb, c), min((b + 1) * cb, c)
        block = torch.cat([f[k][..., lo:hi].to(dev) for f in feats], dim=1)
        if hi - lo < cb:
            block = F.pad(block, (0, cb - (hi - lo)))
        blocks.append(block.contiguous())
    mask = (torch.arange(nd * cb, device=devs[0]) < c).float()
    return blocks, mask, c


def _block_sum(parts, device) -> torch.Tensor:
    """A channel reduction finished over the blocks, in block order, on
    ``device`` (the JAX ``csum``)."""
    total = None
    for p in parts:
        p = p.to(device)
        total = p if total is None else total + p
    return total


def _global_moments(f, g):
    """Global spatial moments of a stage smaller than the window, each
    (N, 1, 1, C): as ``core.adists._global_stage`` forms them."""
    f, g = f.float(), g.float()
    mf = f.mean(dim=(1, 2), keepdim=True)
    mg = g.mean(dim=(1, 2), keepdim=True)
    vf = (f - mf).square().mean(dim=(1, 2), keepdim=True)
    vg = (g - mg).square().mean(dim=(1, 2), keepdim=True)
    cov = (f * g).mean(dim=(1, 2), keepdim=True) - mf * mg
    return mf, mg, vf, vg, cov


def spatial_adists_forward(models: dict[torch.device, VGG16Pyramid],
                           x: torch.Tensor, y: torch.Tensor, mesh: Mesh,
                           cfg: ADISTSConfig | None = None, as_loss: bool = True,
                           as_map: bool = False) -> torch.Tensor:
    """Full-resolution ADISTS of NHWC batches in [0, 1] with H split over
    the mesh's model axis and the batch over its data axis; semantics of
    ``core.adists.forward``. ``models`` as for
    :func:`spatial_dists_forward`. On CUDA tensors each channel block
    launches the T/S kernel once per windowed stage.

    The order of the sums differs from the JAX module's: it shares each
    stage's five windowed moments between γ and T/S
    (``_stage_moments_blocked``), where here γ comes from
    ``windowed_gamma_sum`` and the T/S map from the kernel, as in the
    port's single-device forward. The T/S map is linear over channels, so
    each block's map (the global ps, the block's weights and inverse
    norms) is summed over the blocks."""
    cfg = cfg or ADISTSConfig()
    nd = mesh.shape[MODEL_AXIS]
    n, hh, ww, _ = x.shape
    _check_aligned(hh, ww, nd, "ADISTS")
    dtype = torch_dtype(cfg.compute_dtype)
    ws = cfg.window_size
    tsd = (windowed_tsd if cfg.fused_tsd else
           functools.partial(windowed_tsd_plain, channel_block=cfg.channel_block))
    outs = []
    for r, slabs in enumerate(shard_frames_spatial(mesh, (x, y))):
        devs = mesh.devices[r]
        dev0 = devs[0]
        nl = slabs[0][0].shape[0]
        feats = _row_pyramid(mesh, models, r, slabs, dtype)
        blocks, masks, chns = zip(*(_channel_blocks(feats, k, nd, devs)
                                    for k in range(6)))
        del feats
        with true_fp32():
            # -- entropy channel weights (ADISTS.py:127-135, 152-160) --
            parts = []
            for k in range(6):
                ents = [channel_entropy(b[:nl]) for b in blocks[k]]
                ssum = _block_sum([e.sum(-1, keepdim=True) for e in ents], dev0)
                parts += [e.to(dev0) / (ssum + _C0) * chns[k] for e in ents]
            mask = torch.cat(masks)[None, :]
            weight = torch.cat(parts, dim=1) * mask
            total_c = sum(chns)
            weight = weight / weight.sum(-1, keepdim=True)
            w_mean = weight.sum(-1, keepdim=True) / total_c
            w_std = (((weight - w_mean).square() * mask).sum(-1, keepdim=True)
                     / total_c).sqrt()
            weight = torch.clamp(weight, w_mean - 0.5 * w_std,
                                 w_mean + 0.5 * w_std) * mask
            weight = weight / weight.sum(-1, keepdim=True)

            # -- the coarse -> fine cascade: ps and the T/S maps --
            offs = [0]
            for m in masks:
                offs.append(offs[-1] + m.numel())
            d_total = torch.zeros((nl,), dtype=torch.float32, device=dev0)
            d_map_full = (torch.zeros((nl, hh, ww), dtype=torch.float32, device=dev0)
                          if as_map else None)
            ps_prod = torch.ones((nl, hh, ww, 1), dtype=torch.float32, device=dev0)
            for k in reversed(range(6)):
                cb = masks[k].numel() // nd
                fs = [b[:nl] for b in blocks[k]]
                gs = [b[nl:] for b in blocks[k]]
                wks = [weight[:, offs[k] + i * cb:offs[k] + (i + 1) * cb].to(dev)
                       for i, dev in enumerate(devs)]
                invs = [(_inv_l2_norm(f), _inv_l2_norm(g)) for f, g in zip(fs, gs)]
                h, w = fs[0].shape[1], fs[0].shape[2]
                if fits_window(h, w, ws):
                    gamma = _block_sum([windowed_gamma_sum(f, ws, cfg.channel_block)
                                        for f in fs], dev0) / chns[k]
                    ps_prod = _prob_update(gamma, ps_prod, True)
                    d_map = _block_sum([
                        tsd(f, g, ps_prod.to(f.device), wk, ws, inv_x=ix, inv_y=iy)
                        for f, g, wk, (ix, iy) in zip(fs, gs, wks, invs)], dev0)
                else:
                    mom = [_global_moments(f, g) for f, g in zip(fs, gs)]
                    gamma = _block_sum([(vf / (mf + _C0)).sum(-1, keepdim=True)
                                        for mf, _, vf, _, _ in mom], dev0) / chns[k]
                    ps_prod = _prob_update(gamma, ps_prod, False)
                    d_parts = []
                    for (mf, mg, vf, vg, cov), wk, (ix, iy) in zip(mom, wks, invs):
                        ix, iy = ix[:, None, None, :], iy[:, None, None, :]
                        ps = ps_prod.to(mf.device)
                        xm, ym = ix * mf, iy * mg
                        t = (2 * xm * ym + _EPS) / (xm.square() + ym.square() + _EPS)
                        s = (2 * (ix * iy * cov) + _EPS) / (
                            ix.square() * vf + iy.square() * vg + _EPS)
                        d_parts.append((((1.0 - ps) * t + ps * s)
                                        * wk[:, None, None, :]).sum(dim=-1))
                    d_map = _block_sum(d_parts, dev0)
                if as_map:
                    d_map_full += resize_bilinear(d_map[..., None], hh, ww)[..., 0]
                d_total += d_map.mean(dim=(1, 2))
        out = 1.0 - (d_map_full if as_map else d_total)
        outs.append(out.to(mesh.primary))
    out = torch.cat(outs)
    if as_map or not as_loss:
        return out
    return out.mean()
