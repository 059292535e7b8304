"""One-command verification chain for real pretrained checkpoints, on the GPU.

Counterpart of ``nerf_qa_tpu/tools/verify_assets.py``. The quality claims
(golden 0.3347, the paper's correlations — results_table.tex:9,
results_table_test2.tex:9-10) need real backbones: torchvision VGG16
(DISTS_pt.py:51-52), DINOv2 ViT-S/14-reg (model.py:64), FeatUp's JBU
upsampler (model_nr_v8.py:112-136) and trained model.pth heads. The day
those files exist, readiness is a single command:

  python -m nerf_qa_torch.tools.verify_assets --assets-dir /path/to/ckpts

It discovers checkpoints by file name (or takes explicit flags), runs every
verification the found set allows, prints one PASS/FAIL/SKIP line per
check, and exits 0 iff nothing failed and at least one check ran (1 on a
failure, 2 when nothing ran):

  vgg_golden     load VGG16 -> score the demo pair (needs r0.png + r1.png
                 in the assets dir or --ref/--dist) -> assert
                 |score - 0.3347| < 1e-3 (DISTS_pt.py:239)
  vgg_sanity     (fallback when demo images are absent) DISTS(x,x)=0 and
                 DISTS strictly increases with distortion
  dists_weights  load weights.pt alpha/beta -> match the bundled
                 converted asset
  dinov2         load the ViT -> forward a deterministic image -> finite,
                 non-degenerate token statistics
  featup_jbu     load the JBU upsampler -> NR v8 forward sanity (finite
                 score) with the loaded ViT + JBU
  fr_model       load a reference FR model.pth -> score a synthetic
                 distortion ladder -> SRCC(pred, MOS) > 0 and finite
  nr_model       load a reference NR model.pth (train-nr.py save) ->
                 forward on fixture frames -> finite, non-constant

The reference torch layouts are read by the port's own loaders
(``compat/pretrained.py``, ``tools/reeval.load_params``). On the card the
DISTS statistics take the moments kernel, and the NR forwards the JBU and
ChannelNorm kernels; ``--device cpu`` runs their plain versions.

Discovery patterns (case-insensitive substring of the file name):
  vgg16*          -> VGG, weights.pt -> alpha/beta, *dinov2* -> ViT,
  *featup*|*jbu*  -> JBU, model*.pth tried as FR then NR.
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import sys

import numpy as np
import torch

from nerf_qa_torch.compat import checkpoint, pretrained
from nerf_qa_torch.config import DISTSConfig, FRModelConfig, NRModelConfig, resolve_device
from nerf_qa_torch.core import dists

PASS, FAIL, SKIP = "PASS", "FAIL", "SKIP"
# what a torch.load of a file that is not a checkpoint of the probed kind raises
_LOAD_ERRORS = (OSError, RuntimeError, ValueError, KeyError, EOFError,
                pickle.UnpicklingError)


def _report(name: str, status: str, detail: str) -> tuple[str, str, str]:
    print(f"verify_assets: {name}: {status} — {detail}", flush=True)
    return name, status, detail


def _find(assets_dir: str, *needles: str,
          suffixes=(".pt", ".pth", ".bin", ".npz")):
    """First file in assets_dir whose name contains a needle."""
    if not assets_dir:
        return None
    for path in sorted(glob.glob(os.path.join(assets_dir, "*"))):
        name = os.path.basename(path).lower()
        if name.endswith(suffixes) and any(n in name for n in needles):
            return path
    return None


def _fixture_pairs(n_levels: int = 5, frames: int = 2, hw=(96, 128)):
    """(ref, dist, level) frame pairs with monotonically growing
    distortion — the correlation-smoke substrate."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    base = np.stack([
        0.5 + 0.5 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
        (xx + yy) / sum(hw),
        rng.random(hw),
    ], axis=-1)
    out = []
    for lvl in range(n_levels):
        sigma = 0.02 + 0.06 * lvl
        for _ in range(frames):
            noise = rng.normal(0, sigma, base.shape).astype(np.float32)
            out.append((base.copy(),
                        np.clip(base + noise, 0, 1).astype(np.float32),
                        lvl))
    return out


def _dists_cfg(device: torch.device) -> DISTSConfig:
    """fp32 DISTS; the moments kernel for CUDA tensors."""
    return DISTSConfig(compute_dtype="float32",
                       stats_impl="kernel" if device.type == "cuda" else "eager")


def _batch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(device)


# -- checks -------------------------------------------------------------------

def check_vgg(vgg_path: str, ref_img: str | None, dist_img: str | None,
              dists_weights: str | None, device: torch.device):
    from nerf_qa_torch.tools.golden_check import GOLDEN, compute_pair_score

    if ref_img and dist_img:
        score = compute_pair_score(ref_img, dist_img, vgg_ckpt=vgg_path,
                                   dists_weights=dists_weights, device=device)
        if abs(score - GOLDEN) < 1e-3:
            return _report("vgg_golden", PASS,
                           f"demo pair scores {score:.4f} (golden {GOLDEN})")
        return _report("vgg_golden", FAIL,
                       f"demo pair scores {score:.4f}, expected {GOLDEN}")

    # no demo images: identity + monotonicity sanity on the fixture
    cfg = _dists_cfg(device)
    vgg = pretrained.resolve_vgg_params(vgg_path).to(device).eval()
    w = pretrained.resolve_dists_weights(cfg, dists_weights).to(device)

    def step(x, y):
        with torch.no_grad():
            return float(dists.forward(vgg, w, _batch(x, device), _batch(y, device), cfg)[0])

    pairs = _fixture_pairs(n_levels=4, frames=1)
    scores = [step(d, r) for r, d, _ in pairs]
    ident = step(pairs[0][0], pairs[0][0])
    mono = all(b > a for a, b in zip(scores, scores[1:]))
    if abs(ident) < 1e-4 and mono and all(0 <= s <= 1 for s in scores):
        return _report(
            "vgg_sanity", PASS,
            f"DISTS(x,x)={ident:.2e}, distortion-monotone scores "
            f"{[round(s, 4) for s in scores]} (golden check SKIPPED: no "
            f"demo images r0.png/r1.png — pass --ref/--dist)")
    return _report("vgg_sanity", FAIL,
                   f"identity={ident:.2e}, scores={scores}")


def check_dists_weights(path: str):
    raw = pretrained._torch_load(path)
    a, b = (torch.as_tensor(raw[k]).detach().reshape(-1).float().numpy()
            for k in ("alpha", "beta"))
    bundled = dists.load_pretrained_weights()
    if a.shape != (1475,) or b.shape != (1475,):
        return _report("dists_weights", FAIL,
                       f"bad shapes {a.shape}/{b.shape}, want (1475,)")
    ba, bb = bundled.alpha.numpy(), bundled.beta.numpy()
    if np.allclose(a, ba, atol=1e-7) and np.allclose(b, bb, atol=1e-7):
        return _report("dists_weights", PASS,
                       "alpha/beta match the bundled converted asset")
    return _report("dists_weights", FAIL,
                   "alpha/beta differ from the bundled asset "
                   f"(max |da|={np.abs(a - ba).max():.2e})")


def check_dinov2(path: str, device: torch.device, depth: int = 12):
    vit = pretrained.resolve_vit_params(path, depth=depth).to(device).eval()
    img = _fixture_pairs(n_levels=1, frames=1, hw=(224, 224))[0][0]
    with torch.no_grad():
        tokens = vit(_batch(img, device))["x_norm_patchtokens"].float().cpu().numpy()
    std = float(tokens.std())
    if np.isfinite(tokens).all() and 1e-3 < std < 1e3:
        return _report("dinov2", PASS,
                       f"tokens {tokens.shape}, mean {tokens.mean():.4f}, "
                       f"std {std:.4f}")
    return _report("dinov2", FAIL,
                   f"degenerate tokens: finite={np.isfinite(tokens).all()} "
                   f"std={std:.2e}")


def _nr_model(vgg_path, vit_path, jbu_path, cfg: NRModelConfig,
              device: torch.device, depth: int = 12, decoder=None, weights=None):
    """NR v8 at render 128 / sem 112 with the loaded backbones (random
    decoder unless given)."""
    from nerf_qa_torch.models.nr.model import NRModel

    vit = pretrained.resolve_vit_params(vit_path, depth=depth, grid_size=112 // 14)
    return NRModel(pretrained.resolve_vgg_params(vgg_path), weights, cfg, vit=vit,
                   jbu=pretrained.resolve_jbu_params(jbu_path, dim=vit.embed_dim),
                   decoder=decoder, render_size=128, sem_size=112).to(device)


def check_featup(jbu_path: str, vit_path: str | None, vgg_path: str | None,
                 device: torch.device, depth: int = 12):
    cfg = NRModelConfig(transformer_decoder_depth=1, refine_up_depth=1,
                        dists=_dists_cfg(device))
    model = _nr_model(vgg_path, vit_path, jbu_path, cfg, device, depth)
    d = _fixture_pairs(n_levels=1, frames=1, hw=(128, 128))[0][1]
    r224 = _fixture_pairs(n_levels=1, frames=1, hw=(112, 112))[0][0]
    with torch.no_grad():
        score = model(_batch(d, device), _batch(r224, device)).float().cpu().numpy()
    if np.isfinite(score).all():
        return _report("featup_jbu", PASS,
                       f"NR v8 forward with the loaded JBU: score "
                       f"{float(score[0]):.4f}")
    return _report("featup_jbu", FAIL, f"non-finite NR forward: {score}")


def check_fr_model(path: str, vgg_path: str | None, device: torch.device):
    """Load a reference FR model.pth and smoke-test its correlation on the
    synthetic distortion ladder (pred MOS must fall as distortion grows:
    SRCC(pred, level) < 0, i.e. SRCC(pred, MOS) > 0)."""
    from scipy import stats as sps

    from nerf_qa_torch.core.vgg import VGG16Pyramid
    from nerf_qa_torch.models import fr
    from nerf_qa_torch.tools.reeval import load_params

    cfg = FRModelConfig(regression_type="logistic", dists=_dists_cfg(device))
    try:
        params, embedded_vgg = load_params(path, cfg)
    except _LOAD_ERRORS as e:
        return _report("fr_model", FAIL, f"import failed: {e}")
    if not params.get("head"):
        return _report("fr_model", FAIL,
                       "no head parameters found in the state dict")
    if embedded_vgg is not None and not vgg_path:
        vgg = VGG16Pyramid()
        vgg.load_state_dict(embedded_vgg, strict=True)
    else:
        vgg = pretrained.resolve_vgg_params(vgg_path)
    vgg = vgg.to(device).eval()
    reg = "logistic" if "b1" in params["head"] else "linear"
    cfg = FRModelConfig(regression_type=reg, dists=cfg.dists)
    params = {"head": {k: v.to(device) for k, v in params["head"].items()},
              "dists": params["dists"].to(device)}

    preds, levels = [], []
    for r, d, lvl in _fixture_pairs():
        with torch.no_grad():
            pred = fr.forward(params, vgg, _batch(d, device), _batch(r, device), cfg)[0]
        preds.append(float(pred[0]))
        levels.append(lvl)
    preds, levels = np.asarray(preds), np.asarray(levels)
    if not np.isfinite(preds).all():
        return _report("fr_model", FAIL, f"non-finite predictions {preds}")
    if preds.std() < 1e-8:
        return _report("fr_model", FAIL, f"constant predictions {preds[0]}")
    srcc = float(sps.spearmanr(preds, -levels).statistic)
    if srcc > 0:
        return _report("fr_model", PASS,
                       f"{reg} head, fixture SRCC(pred, MOS)={srcc:.3f}")
    return _report("fr_model", FAIL,
                   f"fixture SRCC(pred, MOS)={srcc:.3f} <= 0 "
                   f"(preds {preds.round(3).tolist()})")


def nr_depths(decoder_sd) -> tuple[int, int]:
    """(transformer_decoder_depth, refine_up_depth) of a v7/v8 decoder
    ``state_dict``, from its ``transformer_decoder.{i}`` blocks and the
    ``decoder.0.block.{j}`` blocks of its first RefineUp stage."""
    trans = len({k.split(".")[1] for k in decoder_sd
                 if k.startswith("transformer_decoder.")})
    refine = len({k.split(".")[3] for k in decoder_sd if k.startswith("decoder.0.block.")})
    if not refine:
        raise ValueError("no RefineUp blocks (decoder.0.block.*) in the decoder")
    return trans, refine


def check_nr_model(path: str, vgg_path: str | None, vit_path: str | None,
                   jbu_path: str | None, device: torch.device):
    from nerf_qa_torch.models.nr.decoder import NRDecoder

    try:
        decoder_sd, alpha_beta = pretrained.load_nr_torch_file(path)
        trans, depth = nr_depths(decoder_sd)
        cfg = NRModelConfig(transformer_decoder_depth=trans, refine_up_depth=depth,
                            dists=_dists_cfg(device))
        decoder = NRDecoder.from_state_dict(decoder_sd, cfg)
    except _LOAD_ERRORS as e:
        return _report("nr_model", FAIL, f"import failed: {e}")
    weights = None if alpha_beta is None else dists.DISTSWeights(
        torch.from_numpy(alpha_beta[0]), torch.from_numpy(alpha_beta[1]))
    model = _nr_model(vgg_path, vit_path, jbu_path, cfg, device, decoder=decoder,
                      weights=weights)
    pairs = _fixture_pairs(n_levels=3, frames=1, hw=(128, 128))
    p224 = _fixture_pairs(n_levels=3, frames=1, hw=(112, 112))
    scores = []
    for (_, d, _), (_, d2, _) in zip(pairs, p224):
        with torch.no_grad():
            scores.append(float(model(_batch(d, device), _batch(d2, device))[0]))
    arr = np.asarray(scores)
    if np.isfinite(arr).all() and arr.std() > 1e-8:
        return _report("nr_model", PASS,
                       f"forward scores {arr.round(4).tolist()} "
                       f"(finite, non-constant)")
    return _report("nr_model", FAIL, f"degenerate scores {scores}")


# -- driver -------------------------------------------------------------------

def _is_fr_model(path: str) -> bool:
    """FR saves carry head params (b1..b4 / dists_weight); NR saves carry
    decoder blocks."""
    try:
        return bool(checkpoint.convert_fr_model_from_torch(path)[0])
    except _LOAD_ERRORS:
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="verify a directory of real pretrained checkpoints")
    p.add_argument("--assets-dir", default=None,
                   help="directory to auto-discover checkpoints in")
    p.add_argument("--ref", default=None,
                   help="golden demo reference image (r0.png)")
    p.add_argument("--dist", default=None,
                   help="golden demo distorted image (r1.png)")
    p.add_argument("--fr-model", default=None,
                   help="reference FR model.pth (overrides discovery)")
    p.add_argument("--nr-model", default=None,
                   help="reference NR model.pth (overrides discovery)")
    p.add_argument("--vit-depth", type=int, default=12)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    pretrained.add_backbone_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    d = args.assets_dir
    vgg = args.vgg_ckpt or _find(d, "vgg16", "vgg-16", "vgg_16")
    dw = args.dists_weights or _find(d, "weights")
    vit = args.vit_ckpt or _find(d, "dinov2", "dino_v2")
    jbu = args.jbu_ckpt or _find(d, "featup", "jbu")
    fr_pth = args.fr_model
    nr_pth = args.nr_model
    if d and not (fr_pth or nr_pth):
        for path in sorted(glob.glob(os.path.join(d, "model*.pth"))):
            if not fr_pth and _is_fr_model(path):
                fr_pth = path
                continue
            nr_pth = nr_pth or path
    ref_img = args.ref or _find(d, "r0", suffixes=(".png", ".jpg"))
    dist_img = args.dist or _find(d, "r1", suffixes=(".png", ".jpg"))

    results = []
    if vgg:
        results.append(check_vgg(vgg, ref_img, dist_img, dw, device))
    else:
        results.append(_report("vgg_golden", SKIP,
                               "no vgg16*.pth found (--vgg-ckpt)"))
    if dw:
        results.append(check_dists_weights(dw))
    else:
        results.append(_report("dists_weights", SKIP,
                               "no weights.pt found (--dists-weights); "
                               "the bundled asset is used"))
    if vit:
        results.append(check_dinov2(vit, device, depth=args.vit_depth))
    else:
        results.append(_report("dinov2", SKIP,
                               "no *dinov2*.pth found (--vit-ckpt)"))
    if jbu:
        results.append(check_featup(jbu, vit, vgg, device, depth=args.vit_depth))
    else:
        results.append(_report("featup_jbu", SKIP,
                               "no *featup*/*jbu*.pth found (--jbu-ckpt)"))
    if fr_pth:
        results.append(check_fr_model(fr_pth, vgg, device))
    else:
        results.append(_report("fr_model", SKIP,
                               "no FR model*.pth found (--fr-model)"))
    if nr_pth:
        results.append(check_nr_model(nr_pth, vgg, vit, jbu, device))
    else:
        results.append(_report("nr_model", SKIP,
                               "no NR model*.pth found (--nr-model)"))

    n_pass = sum(1 for _, s, _ in results if s == PASS)
    n_fail = sum(1 for _, s, _ in results if s == FAIL)
    n_skip = sum(1 for _, s, _ in results if s == SKIP)
    print(f"verify_assets: {n_pass} passed, {n_fail} failed, "
          f"{n_skip} skipped", flush=True)
    if n_fail:
        return 1
    if not n_pass:
        print("verify_assets: nothing to verify — no checkpoints found",
              flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
