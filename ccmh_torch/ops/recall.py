"""Recall@K and rank metrics of a similarity matrix (port of
``ccmh/ops/recall.py``; the reference's utils/utils.py:7-24
``compute_metrics``: R@1/5/10, MedianR, MeanR)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def compute_metrics(sim) -> Dict[str, float]:
    """sim: [N, N] similarity (tensor or array), the ground truth on the
    diagonal.  An item's rank is the count of its row's entries above the
    diagonal entry (0-based)."""
    sim = torch.as_tensor(sim)
    diag = torch.diagonal(sim)
    rank_np = (sim > diag[:, None]).sum(1).cpu().numpy()
    n = rank_np.shape[0]
    return {
        "R1": float(np.sum(rank_np == 0)) * 100 / n,
        "R5": float(np.sum(rank_np < 5)) * 100 / n,
        "R10": float(np.sum(rank_np < 10)) * 100 / n,
        "MR": float(np.median(rank_np) + 1),
        "MedianR": float(np.median(rank_np) + 1),
        "MeanR": float(np.mean(rank_np) + 1),
        "cols": [int(i) for i in rank_np],
    }
