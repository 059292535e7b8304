"""Two measurements on the card behind bars of ``chip_smoke.py`` (PERF.md
§6): how far cuDNN's batch-size-dependent algorithms move a score or a
gradient.

* ``position_probe``: which bf16 VGG convolutions give an image bits that
  depend on its batch, the cuDNN kernels the stage-5 conv runs at batch
  128, 64 and 1, the largest DISTS and ADISTS gap of a frame between
  batch 128, batch 64 and alone over 8 seeded batches (the source of
  ``chip_smoke.DP_BF16_BOUND``), and FR frames/s with cuDNN's default
  algorithms, its deterministic ones, and without cuDNN.
* ``fp32_turns``: the fp32 NR training step's kernels-vs-plain gradient
  comparison over 32 turns, with every ChannelNorm backward and JBU call
  of each turn replayed alone against its plain version.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 probes/cudnn_numerics.py

It builds the kernels, as ``chip_smoke.py`` does, and prints one JSON line
a probe. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

BOUND_SEED = 21  # the frames of the bound's 8 batches
TURNS = 32  # fp32 kernels-vs-plain step comparisons of fp32_turns


@contextlib.contextmanager
def cudnn_mode(mode: str):
    """'default', 'deterministic' (torch.backends.cudnn.deterministic) or
    'no_cudnn' (cuDNN off: PyTorch's own convolutions) inside the block."""
    if mode == "no_cudnn":
        with torch.backends.cudnn.flags(enabled=False):
            yield
        return
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = mode == "deterministic"
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def position_probe(model, weights) -> None:
    """Which bf16 VGG convolutions give an image bits that depend on its
    batch (each conv at the 256² pyramid's shapes: image 0 of 128 and
    image 127 against each alone, the first 64 of 128 against a batch of
    64), the cuDNN kernels of the stage-5 conv at batch 128, 64 and 1
    (profiler), each with and without cudnn.deterministic; then the bound
    (chip_smoke.DP_BF16_BOUND): over 8 batches of 128 uint8 1080p pairs
    (BOUND_SEED) resized to 256², each frame's DISTS and ADISTS at batch
    128 against at 64 and (every fourth) alone, bf16 and fp32 (2
    batches); and FR frames/s at batch 128 by mode, in turns."""
    from nerf_qa_torch.config import ADISTSConfig, DISTSConfig
    from nerf_qa_torch.core import adists, dists
    from nerf_qa_torch.core.vgg import STAGE_CONV_INDICES, VGG16_STAGES
    from nerf_qa_torch.eval.video_scorer import FrameScorer, _prep

    model = model.to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, hw = [], 256
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for si, (spec, idxs) in enumerate(zip(VGG16_STAGES, STAGE_CONV_INDICES)):
        for (cin, cout), idx in zip(spec, idxs):
            wt = getattr(model.stage(si + 1), str(idx)).weight.to(torch.bfloat16)
            x = torch.randn((cs.BATCH, cin, hw, hw), generator=gen, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            row = {"stage": si + 1, "conv": idx, "cin": cin, "cout": cout, "hw": hw}
            for mode in ("default", "deterministic"):
                with cudnn_mode(mode), torch.no_grad():
                    full = F.conv2d(x, wt, padding=1)
                    row[mode] = {
                        "pos0_vs_alone": float((full[0] - F.conv2d(x[:1], wt, padding=1)[0])
                                               .abs().max()),
                        "pos127_vs_alone": float((full[-1] - F.conv2d(x[-1:], wt, padding=1)[0])
                                                 .abs().max()),
                        "b64_vs_b128": float((F.conv2d(x[:64], wt, padding=1) - full[:64])
                                             .abs().max())}
                    if si == 4 and idx == idxs[-1]:
                        for n in (cs.BATCH, 64, 1):
                            torch.cuda.synchronize()
                            with torch.profiler.profile(activities=acts) as prof:
                                F.conv2d(x[:n], wt, padding=1)
                                torch.cuda.synchronize()
                            row.setdefault("kernels", {})[f"{mode} batch {n}"] = sorted(
                                {e.key[:160] for e in prof.key_averages() if cs._on_device(e)})
            rows.append(row)
            del x
        hw = hw // 2 if si < 4 else hw
    cs.phase("position_convs", rows=rows)

    gen = torch.Generator(device="cuda").manual_seed(BOUND_SEED)
    bound = {}
    for dtype, n_batches in (("bfloat16", 8), ("float32", 2)):
        cfg = DISTSConfig(compute_dtype=dtype, stats_impl="kernel")
        acfg = ADISTSConfig(compute_dtype=dtype)
        w = weights.to("cuda")
        fns = {"dists": lambda a, b: dists.forward(model, w, a, b, cfg),
               "adists": lambda a, b: adists.forward(model, a, b, acfg, as_loss=False)}
        gaps = {k: {"b64": 0.0, "alone": 0.0} for k in fns}
        for _ in range(n_batches):
            d, r = cs.seeded_frames(gen, cs.BATCH)
            with torch.no_grad():
                x = _prep(d, (256, 256), dtype == "bfloat16")
                y = _prep(r, (256, 256), dtype == "bfloat16")
                for name, fn in fns.items():
                    s128 = fn(x, y)
                    s64 = torch.cat([fn(x[:64], y[:64]), fn(x[64:], y[64:])])
                    s1 = torch.cat([fn(x[i:i + 1], y[i:i + 1]) for i in range(0, cs.BATCH, 4)])
                    gaps[name]["b64"] = max(gaps[name]["b64"], float((s128 - s64).abs().max()))
                    gaps[name]["alone"] = max(gaps[name]["alone"],
                                              float((s128[::4] - s1).abs().max()))
            del d, r, x, y
        bound[dtype] = dict(batches=n_batches, gaps=gaps)
    cfg = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
    scorer = FrameScorer(model, weights, cfg)
    d, r = cs.seeded_frames(gen, cs.BATCH)
    fps = {}
    for mode in ("default", "deterministic", "no_cudnn", "deterministic", "default"):
        n = 2 if mode == "no_cudnn" else 10
        with cudnn_mode(mode):
            scorer.score_batch(d, r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                scorer.score_batch(d, r)
            torch.cuda.synchronize()
        fps.setdefault(mode, []).append(n * cs.BATCH / (time.perf_counter() - t0))
    cs.phase("position_bound", seed=BOUND_SEED, bound=bound, fr_frames_per_s=fps,
             recorded_bound=cs.DP_BF16_BOUND)


def fp32_turns(vgg, gen) -> None:
    """chip_smoke.nr_train_path's fp32 kernels-vs-plain step comparison,
    TURNS turns on fresh batches with an Adam step between them: the
    worst per-tensor gradient gap of each turn beside cuDNN's own repeat
    spread and the same comparison under its deterministic algorithms;
    every ChannelNorm backward and JBU call of the kernels' step replayed
    alone against its plain version."""
    from nerf_qa_torch.models.nr import featup
    from nerf_qa_torch.ops.cuda import channelnorm, jbu

    weights, vit, jb = cs.nr_backbones()
    trainer = cs.make_trainer(vgg, weights, "float32", vit, jb)
    real_bwd, real_jbu = channelnorm.channel_norm_act_bwd, featup.jbu_filter
    rows = []
    for turn in range(TURNS):
        batch = cs.train_batch(gen)
        state = trainer.generator.get_state()
        rec_bwd, rec_jbu = [], []

        def bwd(x, g, scale, bias, *, gelu=False, eps=1e-5):
            rec_bwd.append((x.clone(), g.clone(), scale.clone(), bias.clone(), gelu))
            return real_bwd(x, g, scale, bias, gelu=gelu, eps=eps)

        def jf(hr, proj, spatial, temp, *a, **k):
            rec_jbu.append((hr.clone(), proj.clone(), spatial.clone(), temp.clone()))
            return real_jbu(hr, proj, spatial, temp, *a, **k)

        channelnorm.channel_norm_act_bwd, featup.jbu_filter = bwd, jf
        try:
            k_l, k_g = cs.step_grads(trainer, batch, state)
        finally:
            channelnorm.channel_norm_act_bwd, featup.jbu_filter = real_bwd, real_jbu
        with cs.plain_versions(trainer.model):
            p_l, p_g = cs.step_grads(trainer, batch, state)
        again = cs.step_grads(trainer, batch, state)[1]
        kd = cs.step_grads(trainer, batch, state, deterministic=True)[1]
        with cs.plain_versions(trainer.model):
            pd = cs.step_grads(trainer, batch, state, deterministic=True)[1]
        gaps, det = cs.grad_gaps(k_g, p_g), cs.grad_gaps(kd, pd)
        worst, dworst = max(gaps, key=gaps.get), max(det, key=det.get)
        cn = []
        for x, g, scale, bias, gelu in rec_bwd:
            got = real_bwd(x, g, scale, bias, gelu=gelu)
            want = channelnorm.channel_norm_act_bwd_plain(x, g, scale, bias, gelu=gelu)
            cn.append(max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                          for a, b in zip(got, want)))
        jb_err = [float((jbu.jbu_filter(*c) - jbu.jbu_filter_plain(*c)).abs().max())
                  for c in rec_jbu]
        rows.append(dict(turn=turn, worst_grad=[worst, gaps[worst]],
                         loss_gap=max(abs(k_l[k] - p_l[k]) for k in k_l),
                         repeat_spread=max(cs.grad_gaps(again, k_g).values()),
                         deterministic_worst=[dworst, det[dworst]],
                         cn_bwd_calls=len(cn), cn_bwd_worst_rel=max(cn),
                         jbu_calls=len(jb_err), jbu_worst_abs=max(jb_err)))
        del rec_bwd, rec_jbu
        trainer.train_step(*batch)
    top = max(rows, key=lambda r: r["worst_grad"][1])
    bar = cs.TRAIN_PLAIN_GRAD_RTOL["float32"]
    cs.phase("fp32_turns", turns=TURNS, bar=bar,
             over_bar=sum(r["worst_grad"][1] > bar for r in rows), worst=top, rows=rows)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("cudnn_numerics: this script needs an NVIDIA GPU")
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights, resolve_vgg_params
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.ops.cuda import build

    build.build(force=True)
    build.load_library()
    vgg = resolve_vgg_params(seed=0).cuda()
    position_probe(vgg, resolve_dists_weights(DISTSConfig()))
    fp32_turns(vgg, torch.Generator(device="cuda").manual_seed(11))
    return 0


if __name__ == "__main__":
    sys.exit(main())
