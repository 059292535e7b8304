"""Window loop ``nr_score``: NR v8 scoring through ``NRScorer.step_batch``
(the score CLI's ``--nr`` path after its host resize), one batch in
flight, each batch's scores read back to the host.

Traffic parameters: ``batch`` renders already on the card at
``render_hw``² and ``sem_hw``² (the 224² copy bilinear, antialiased, from
the 256² one), ``pool_batches`` distinct batches made from the seed and
sent in turn, ``trace_steps`` profiled steps, ``reference_block`` renders
the reference scores at a time.

The check (``portbench/scoring.py``): every score of every window batch
against the plain reference's score of the same render.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.harness import REPO
from portbench.scoring import ScoredEntry
from portbench.spans import Spans, span_name, stats_name


def renders(gen, n: int, hw: int, sem: int, device):
    r256 = torch.rand((n, hw, hw, 3), generator=gen, device=device)
    r224 = F.interpolate(r256.permute(0, 3, 1, 2), size=(sem, sem), mode="bilinear",
                         align_corners=False, antialias=True)
    return r256, r224.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def nr_spans(model) -> Spans:
    """Spans of the NR model's layers: decoder, JBU calls, ChannelNorm
    calls, the VGG pyramid and the DISTS statistics."""
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.models.nr.featup import JBU
    from nerf_qa_torch.models.nr.layers import ChannelNorm

    def jbu_name(mod, args, kwargs):
        source, guidance = args[:2]
        n, h, w, _ = guidance.shape
        return span_name("pb.jbu", n, h, w, source.shape[-1], 4)

    def cn_name(mod, args, kwargs):
        x = args[0]
        n, c, h, w = x.shape
        gelu = kwargs.get("gelu", args[1] if len(args) > 1 else False)
        return span_name("pb.cn", n * h * w, c, gelu, x.element_size())

    spans = Spans()
    spans.module(model.decoder, lambda m, a, k: "pb.decoder")
    spans.modules(model, JBU, jbu_name)
    spans.modules(model, ChannelNorm, cn_name)
    spans.module(model.vgg, lambda m, a, k: "pb.vgg")
    spans.function(dists, "pyramid_stats", stats_name)
    return spans


class Entry(ScoredEntry):
    def __init__(self, ctx):
        from nerf_qa_torch.tools.score import NRScorer

        t, spec, dev = ctx.traffic, ctx.config, ctx.device
        self.ctx = ctx
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        hw, sem = t["render_hw"], t["sem_hw"]
        model, self.weights = ctx.config_code.build(spec, gen, dev, hw, sem, "float32", "kernel")
        self.scorer = NRScorer(model, batch_size=t["batch"], device=dev)
        self.pool = [renders(gen, t["batch"], hw, sem, dev) for _ in range(t["pool_batches"])]
        self.frames_per_step = t["batch"]
        self.trace_steps = t["trace_steps"]
        self.flops_per_step = t["batch"] * ctx.config_code.score_flops(spec, hw, sem)
        self.scores: list[tuple[int, torch.Tensor]] = []
        for r256, r224 in self.pool[:2]:  # warm-up: the one shape the window uses
            self.scorer.step_batch(r256, r224).cpu()

    def step(self, i: int) -> None:
        b = i % len(self.pool)
        self.scores.append((b, self.scorer.step_batch(*self.pool[b]).cpu()))

    def trace_hooks(self) -> Spans:
        return nr_spans(self.scorer.model)

    def _reference_scores(self, lower: bool) -> list[torch.Tensor]:
        ref = self.ctx.reference.Reference(self.weights, self.ctx.config,
                                           str(REPO / self.ctx.config["alpha_beta"]),
                                           self.ctx.device)
        return [ref.score(r256, r224, lower=lower, block=self.ctx.traffic["reference_block"])
                for r256, r224 in self.pool]
