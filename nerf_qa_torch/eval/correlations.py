"""Correlation metrics.

Counterpart of ``nerf_qa_tpu/eval/correlations.py``, the part the NR
trainer uses: ``compute_correlations`` (logger.py:93-102, PLCC/SRCC/KTCC
via scipy). The scene-grouped report and the sweep objective come with
the FR training slice.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import kendalltau, pearsonr, spearmanr


def compute_correlations(pred: np.ndarray, target: np.ndarray) -> dict[str, float]:
    """{'plcc','srcc','ktcc'} (logger.py:93-102)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return {
        "plcc": float(pearsonr(pred, target)[0]),
        "srcc": float(spearmanr(pred, target)[0]),
        "ktcc": float(kendalltau(pred, target)[0]),
    }
