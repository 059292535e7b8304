"""Window loop ``fr_score``: DISTS frame-pair scoring through
``FrameScorer.score_batch`` (the path of ``score`` and ``serve``), one
batch in flight, each batch's scores read back to the host as
``batched_map`` does.

Traffic parameters: ``batch`` pairs of ``frame_hw`` RGB frames, fed as
``feed`` says: ``device_uint8``, uint8 frames already on the card, or
``host_float32``, float32 frames in [0, 1] in the host's own (pageable)
memory, as ``score``'s ``_load_frames`` hands them over after its host
resize, so that each batch's copy to the card is in the window;
``resize_to`` (null: scored at the frames' size), ``pool_batches`` distinct
batches made on the card from the seed and sent in turn (reference frames
uniform, each distorted frame its reference plus a uniform step in
±``noise``/255, clipped), ``trace_steps`` profiled steps,
``reference_block`` pairs the reference scores at a time.

The check (``portbench/scoring.py``): every score of every window batch
against the plain reference's score of the same pair.
"""
from __future__ import annotations

import torch

from portbench.harness import REPO
from portbench.scoring import ScoredEntry
from portbench.spans import Spans, stats_name


def frame_pairs(gen, n: int, h: int, w: int, noise: int, feed: str, device):
    """(distorted, reference) frames of one batch, in the ``feed``'s form."""
    if feed == "device_uint8":
        ref = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        step = torch.randint(-noise, noise + 1, ref.shape, generator=gen, device=device,
                             dtype=torch.int16)
        return (ref.to(torch.int16) + step).clamp_(0, 255).to(torch.uint8), ref
    if feed == "host_float32":
        ref = torch.rand((n, h, w, 3), generator=gen, device=device)
        step = (2 * torch.rand(ref.shape, generator=gen, device=device) - 1) * (noise / 255)
        dist = (ref + step).clamp_(0, 1)
        return dist.cpu().numpy(), ref.cpu().numpy()
    raise ValueError(f"unknown feed {feed!r}")


class Entry(ScoredEntry):
    def __init__(self, ctx):
        from nerf_qa_torch.config import DISTSConfig
        from nerf_qa_torch.core import dists
        from nerf_qa_torch.core.vgg import VGG16Pyramid
        from nerf_qa_torch.eval.video_scorer import FrameScorer

        t = ctx.traffic
        self.ctx = ctx
        dev = ctx.device
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.state = ctx.config_code.vgg_state(gen, dev)
        vgg = VGG16Pyramid().to(dev)
        vgg.load_state_dict(self.state)
        self.resize_to = tuple(t["resize_to"]) if t["resize_to"] else None
        cfg = DISTSConfig(compute_dtype="bfloat16", stats_impl="kernel")
        self.scorer = FrameScorer(vgg, dists.load_pretrained_weights(cfg), cfg,
                                  resize_to=self.resize_to, device=dev)
        n, (h, w) = t["batch"], t["frame_hw"]
        self.pool = [frame_pairs(gen, n, h, w, t["noise"], t["feed"], dev)
                     for _ in range(t["pool_batches"])]
        self.frames_per_step = n
        self.trace_steps = t["trace_steps"]
        hw = self.resize_to or (h, w)
        self.flops_per_step = n * ctx.config_code.pair_flops(ctx.config, *hw)
        self.scores: list[tuple[int, torch.Tensor]] = []
        for dist, ref in self.pool:  # warm-up: every shape the window uses
            self.scorer.score_batch(dist, ref).cpu()

    def step(self, i: int) -> None:
        b = i % len(self.pool)
        self.scores.append((b, self.scorer.score_batch(*self.pool[b]).cpu()))

    def trace_hooks(self) -> Spans:
        from nerf_qa_torch.core import dists
        from nerf_qa_torch.eval import video_scorer

        spans = Spans()
        spans.function(video_scorer, "_prep", lambda *a, **k: "pb.prep")
        spans.module(self.scorer.model, lambda m, a, k: "pb.vgg")
        spans.function(dists, "pyramid_stats", stats_name)
        return spans

    def _reference_scores(self, lower: bool) -> list[torch.Tensor]:
        ref_mod, spec, dev = self.ctx.reference, self.ctx.config, self.ctx.device
        alpha, beta = ref_mod.alpha_beta(str(REPO / spec["alpha_beta"]), dev)
        return [ref_mod.score_frames(self.state, alpha, beta, torch.as_tensor(d).to(dev),
                                     torch.as_tensor(r).to(dev), self.resize_to,
                                     lower=lower, block=self.ctx.traffic["reference_block"])
                for d, r in self.pool]
