"""The output check that the scoring window loops share: every score of
every window batch against the plain reference's score of the same frame
or pair (``score_gap``, the largest absolute gap), each pool batch scored
once by the reference after the program's state is freed."""
from __future__ import annotations

import torch


class ScoredEntry:
    """Base of a scoring window loop. A subclass keeps its program in
    ``self.scorer``, appends (pool batch, host scores) of each window batch
    to ``self.scores`` and gives ``_reference_scores(lower)``: the plain
    reference's scores of each pool batch (the control's with ``lower``,
    the reference one precision step below the configuration's)."""

    scorer = None
    scores: list[tuple[int, torch.Tensor]]

    def _reference_scores(self, lower: bool) -> list[torch.Tensor]:
        raise NotImplementedError

    def _want(self, lower: bool = False) -> list[torch.Tensor]:
        self.scorer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return [s.cpu() for s in self._reference_scores(lower)]

    def _limit(self) -> float:
        return self.ctx.limits["score_gap"]["limit"]

    def check(self) -> tuple[list[dict], int]:
        want = self._want()
        gaps = [float((s - want[b]).abs().max()) for b, s in self.scores]
        return ([{"name": "score_gap", "value": max(gaps), "limit": self._limit()}],
                sum(g > self._limit() for g in gaps))

    def control(self) -> list[dict]:
        """The check's number with the control in the program's place."""
        want = self._want()
        got = self._want(lower=True)
        gap = max(float((g - w).abs().max()) for g, w in zip(got, want))
        return [{"name": "score_gap", "value": gap, "limit": self._limit()}]
