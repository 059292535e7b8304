"""Window loop ``adists_score``: ADISTS frame-pair scoring through
``tools.score.adists_batch`` (the call of ``score --metric adists``,
``serve``'s ADISTS batcher and ``prep_fr``), bf16 pyramid and fp32 head,
one batch in flight, each batch's scores read back to the host.

Traffic parameters: ``batch`` pairs of ``frame_hw`` RGB frames, fed as
``feed`` says: ``host_float32``, float32 frames in [0, 1] in the host's own
(pageable) memory, as ``score`` hands them over after its host resize, so
that each batch's copy to the card is in the window, or ``device_float32``,
float32 frames already on the card (``prep_fr --policy full_size``);
``pool_batches`` distinct batches made on the card from the seed and sent
in turn (reference frames uniform, each distorted frame its reference plus
a uniform step in ±``noise``/255, clipped), ``trace_steps`` profiled steps,
``reference_block`` pairs the reference scores at a time.

The check (``portbench/scoring.py``): every score of every window batch
against the plain reference's score of the same pair.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.harness import entry_module
from portbench.scoring import ScoredEntry


def frame_pairs(gen, n: int, h: int, w: int, noise: int, feed: str, device):
    """(distorted, reference) frames of one batch, in the ``feed``'s form."""
    if feed == "device_float32":
        ref = torch.rand((n, h, w, 3), generator=gen, device=device)
        step = (2 * torch.rand(ref.shape, generator=gen, device=device) - 1) * (noise / 255)
        return (ref + step).clamp_(0, 1), ref
    return entry_module("fr_score").frame_pairs(gen, n, h, w, noise, feed, device)


class Entry(ScoredEntry):
    def __init__(self, ctx):
        from nerf_qa_torch.config import ADISTSConfig
        from nerf_qa_torch.core.vgg import VGG16Pyramid
        from nerf_qa_torch.tools import score

        t = ctx.traffic
        self.ctx = ctx
        dev = ctx.device
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.state = ctx.config_code.vgg_state(gen, dev)
        self.scorer = VGG16Pyramid().to(dev).eval()
        self.scorer.load_state_dict(self.state)
        self.tool = score
        self.cfg = ADISTSConfig(compute_dtype="bfloat16")
        n, (h, w) = t["batch"], t["frame_hw"]
        self.pool = [frame_pairs(gen, n, h, w, t["noise"], t["feed"], dev)
                     for _ in range(t["pool_batches"])]
        self.frames_per_step = n
        self.trace_steps = t["trace_steps"]
        self.flops_per_step = n * ctx.config_code.pair_flops(ctx.config, h, w)
        self.scores: list[tuple[int, torch.Tensor]] = []
        for b in range(len(self.pool)):  # warm-up: every shape the window uses
            self._score(b)

    def _score(self, b: int) -> torch.Tensor:
        return self.tool.adists_batch(self.scorer, *self.pool[b], self.cfg).cpu()

    def step(self, i: int) -> None:
        b = i % len(self.pool)
        self.scores.append((b, self._score(b)))

    def trace_hooks(self):
        """None: the per-layer metrics read the program's own spans."""
        return contextlib.nullcontext()

    def _reference_scores(self, lower: bool) -> list[torch.Tensor]:
        ref_mod, dev = self.ctx.reference, self.ctx.device
        return [ref_mod.score_frames(self.state, torch.as_tensor(d).to(dev),
                                     torch.as_tensor(r).to(dev), lower=lower,
                                     block=self.ctx.traffic["reference_block"])
                for d, r in self.pool]
