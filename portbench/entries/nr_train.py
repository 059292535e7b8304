"""Window loop ``nr_train``: NR v8 training through ``NRTrainer.train_step``
(``train_nr``'s step: the ``gt`` objective, bf16 VGG and decoder, Adam),
one step in flight, each step ending when its ``combined`` loss is on the
host, as ``train_epoch`` with an aggregator reads it.

Traffic parameters: ``batch`` ground truths uniform at ``render_hw``², each
render its ground truth plus ``noise``·N(0, 1), clipped, and its
``sem_hw``² copy (bilinear, antialiased); ``pool_batches`` distinct batches
made on the card from the seed; ``checked_steps`` first steps that set-up
drives through the same call on the first batches of the pool before the
window (it continues with the rest, in turn); ``post_steps`` steps that the
same object takes through the same call once the window has closed, on the
batches that follow in turn; ``trace_steps`` profiled steps.

The check, once the window has closed, in two parts that each compare
three numbers with the plain reference on the same batches and the same
dropout masks:

* the start: the reference trains a decoder from the same initial weights
  for ``checked_steps`` steps. ``loss_gap``, the relative gap of the first
  step's ``combined`` loss; ``grad_gap``, over the decoder's leaves, the
  median leaf's gap between the two sides' norms of the first step's
  gradient (the program's worked out from Adam's first moment), each leaf's
  gap relative to the reference's norm of the leaf or of the median leaf,
  whichever is larger; ``update_gap``, the largest such gap of the norm of
  a leaf's change after the checked steps;
* after the window: the program's decoder, Adam's state and the dropout
  generator's state are copied as the window left them, the program takes
  ``post_steps`` more steps, and the reference replays those steps from the
  copy. ``post_loss_gap``, ``post_grad_gap`` and ``post_update_gap`` are the
  same three numbers there (the gradient from the change of Adam's first
  moment). So a step that goes wrong only after set-up is seen too.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's (the transposed conv of the last stage, which no output reads, has
none) are left out of the gradient and update numbers.
"""
from __future__ import annotations

import statistics
import time

import torch
import torch.nn.functional as F

from portbench.harness import REPO

NOUGHT = 1e-3  # leaves under this share of the median gradient norm


def train_batch(gen, n: int, hw: int, sem: int, noise: float, device):
    gt = torch.rand((n, hw, hw, 3), generator=gen, device=device)
    render = (gt + noise * torch.randn(gt.shape, generator=gen, device=device)).clamp(0, 1)
    r224 = F.interpolate(render.permute(0, 3, 1, 2), size=(sem, sem), mode="bilinear",
                         align_corners=False, antialias=True)
    return gt, render, r224.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    """Each leaf's |got − want| / max(want, the median leaf's want)."""
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}


class Entry:
    def __init__(self, ctx):
        from nerf_qa_torch.config import TrainConfig
        from nerf_qa_torch.train.nr_train import NRTrainer

        t, spec, dev = ctx.traffic, ctx.config, ctx.device
        self.ctx = ctx
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        hw, sem = t["render_hw"], t["sem_hw"]
        model, self.weights = ctx.config_code.build(spec, gen, dev, hw, sem, "bfloat16", "eager")
        tr = spec["train"]
        self.train_seed = ctx.seed % 2**63
        self.trainer = NRTrainer(
            model, TrainConfig(lr=tr["lr"], beta1=tr["betas"][0], beta2=tr["betas"][1],
                               eps=tr["eps"], schedule=tr["schedule"], batch_size=t["batch"],
                               seed=self.train_seed),
            steps_per_epoch=1, device=dev)
        self.trainer.set_decoder(model.decoder)
        self.pool = [train_batch(gen, t["batch"], hw, sem, t["noise"], dev)
                     for _ in range(t["pool_batches"])]
        self.frames_per_step = t["batch"]
        self.trace_steps = t["trace_steps"]
        self.flops_per_step = t["batch"] * ctx.config_code.train_flops(spec, hw, sem)
        self.dispatch_s: list[float] = []
        self.checked = t["checked_steps"]
        self.post = t["post_steps"]
        self.beta1 = tr["betas"][0]
        self.steps = 0
        self.losses = []
        params = dict(model.decoder.named_parameters())
        for k in range(self.checked):
            out = self.trainer.train_step(*self.pool[k])
            self.losses.append({name: float(v) for name, v in out.items()})
            if k == 0:
                self.grad_norms = self._grad_norms({})
        self.change = {name: float((p.detach() - self.weights["decoder"][name]).norm())
                       for name, p in params.items()}

    def _adam_state(self) -> dict:
        """The decoder's weights, Adam's moments and step count and the
        dropout generator's state, copied as they stand."""
        opt = self.trainer.optimizer
        params = dict(self.trainer.model.decoder.named_parameters())
        state = {k: opt.state[p] for k, p in params.items() if p in opt.state}
        steps = {int(s["step"]) for s in state.values()} or {0}
        assert len(steps) == 1, f"Adam's leaves are at different steps: {steps}"
        return {"params": {k: p.detach().clone() for k, p in params.items()},
                "exp_avg": {k: s["exp_avg"].clone() for k, s in state.items()},
                "exp_avg_sq": {k: s["exp_avg_sq"].clone() for k, s in state.items()},
                "step": steps.pop(), "generator": self.trainer.generator.get_state()}

    def _grad_norms(self, before: dict) -> dict:
        """Each leaf's norm of the gradient of the step just taken, from
        the change of Adam's first moment (``before``: the moments before
        that step; none before the first)."""
        opt, b1 = self.trainer.optimizer, self.beta1
        out = {}
        for k, p in self.trainer.model.decoder.named_parameters():
            if p in opt.state:
                m = opt.state[p]["exp_avg"]
                prev = before.get(k)
                g = m if prev is None else m - b1 * prev
                out[k] = float(g.norm()) / (1 - b1)
        return out

    def _copy_state(self) -> None:
        """The copy of the program's state after the window, and the
        batches of the steps that follow it, in turn."""
        self.start = self._adam_state()
        first = self.checked + self.steps
        self.post_batches = [self.pool[(first + k) % len(self.pool)]
                             for k in range(self.post)]

    def _post_window(self) -> None:
        """The program's ``post_steps`` steps after the window, from a copy
        of its state as the window left it."""
        self._copy_state()
        self.post_losses = []
        for k, batch in enumerate(self.post_batches):
            out = self.trainer.train_step(*batch)
            self.post_losses.append({name: float(v) for name, v in out.items()})
            if k == 0:
                self.post_grads = self._grad_norms(self.start["exp_avg"])
        self.post_change = {
            name: float((p.detach() - self.start["params"][name]).norm())
            for name, p in self.trainer.model.decoder.named_parameters()}

    def step(self, i: int) -> None:
        batch = self.pool[(i + self.checked) % len(self.pool)]
        a = time.perf_counter()
        losses = self.trainer.train_step(*batch)
        self.dispatch_s.append(time.perf_counter() - a)
        float(losses["combined"])
        self.steps += 1

    def trace_hooks(self):
        import contextlib

        return contextlib.nullcontext()  # the port's own nr.* ranges

    def _reference(self, lower: bool = False):
        """The reference's (losses, first gradient norms, changes) over the
        checked steps from the initial weights, and over the post-window
        steps from the copy of the program's state (the control's with
        ``lower``); the program's state is freed first."""
        self.trainer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.ctx.reference.Reference(self.weights, self.ctx.config,
                                           str(REPO / self.ctx.config["alpha_beta"]),
                                           self.ctx.device)
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.train_seed)
        first = ref.train(self.pool[:self.checked], gen, lower)
        gen = torch.Generator(device=dev)
        gen.set_state(self.start["generator"])
        return first, ref.train(self.post_batches, gen, lower, start=self.start)

    def _gaps(self, losses, grads, change, ref, prefix: str = "") -> list[dict]:
        r_losses, r_grads, r_change = ref
        lim = self.ctx.limits
        med = statistics.median(r_grads.values())
        kept = [k for k, g in r_grads.items() if g >= NOUGHT * med]
        step_gaps = [abs(a["combined"] - b["combined"]) / abs(b["combined"])
                     for a, b in zip(losses, r_losses)]
        grad = {k: grads.get(k, 0.0) for k in kept}
        g_gaps = leaf_gaps(grad, r_grads, kept)
        u_gaps = leaf_gaps(change, r_change, kept)
        # recorded beside the compared numbers: every step's loss gap (the
        # later ones carry the rounding of the earlier updates), and the
        # worst leaf's gradient gap (a ChannelNorm scale or a conv bias
        # whose gradient is a sum over every pixel of the batch)
        g_worst = max(g_gaps, key=g_gaps.get)
        self.readings.update({
            prefix + "loss_gap_steps": step_gaps,
            prefix + "grad_worst_leaf": g_worst, prefix + "grad_worst_gap": g_gaps[g_worst],
            prefix + "update_worst_leaf": max(u_gaps, key=u_gaps.get),
            prefix + "update_median_gap": statistics.median(u_gaps.values())})
        vals = {"loss_gap": step_gaps[0],
                "grad_gap": statistics.median(g_gaps.values()),
                "update_gap": max(u_gaps.values())}
        return [{"name": prefix + k, "value": v, "limit": lim[prefix + k]["limit"]}
                for k, v in vals.items()]

    def check(self) -> tuple[list[dict], int]:
        self._post_window()
        first, post = self._reference()
        self.readings = {}
        checks = (self._gaps(self.losses, self.grad_norms, self.change, first)
                  + self._gaps(self.post_losses, self.post_grads, self.post_change, post,
                               "post_"))
        return checks, sum(c["value"] > c["limit"] for c in checks)

    def control(self) -> list[dict]:
        """The check's numbers with the control (the reference one precision
        step down) in the program's place, after the window from the same
        copy of the program's state."""
        self._copy_state()
        want_first, want_post = self._reference()
        low_first, low_post = self._reference(lower=True)
        self.readings = {}
        return self._gaps(*low_first, want_first) + self._gaps(*low_post, want_post, "post_")
