"""DSPH HyP proxy loss (TCSVT'23).

Port of ``ccmh/losses/dsph.py`` (train/DSPH/loss.py:22-72): cosine proxy
terms thresholded by the code-table value, plus the optional pairwise
regulariser among multi-label samples, as fixed-shape masked reductions.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Tuple

import torch

from ccmh_torch.ops.similarity import l2_normalize

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
CODETABLE_PATH = os.path.join(_ASSET_DIR, "codetable.xlsx")


@functools.lru_cache(maxsize=None)
def codetable_threshold(output_dim: int, numclass: int, path: str = CODETABLE_PATH) -> float:
    """codetable.xlsx[row=output_dim][col=ceil(log2 numclass)]
    (train/DSPH/loss.py:19-20); read once per (K, C), since the eager step
    asks for it every step."""
    from ccmh_torch.utils.xlsx import read_cell

    value = read_cell(path, output_dim, math.ceil(math.log(numclass, 2)))
    if value is None:
        raise ValueError(f"no codetable threshold for K={output_dim}, C={numclass}")
    return float(value)


def hyp_loss(x: torch.Tensor, y: torch.Tensor, label: torch.Tensor, proxies: torch.Tensor,
             threshold: float, alpha: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = l2_normalize(proxies)
    cos = l2_normalize(x) @ p.T                    # [B, C]
    cos_t = l2_normalize(y) @ p.T

    pos_mask = (label == 1).float()
    neg_mask = (label == 0).float()
    p_num = torch.clamp(pos_mask.sum(), min=1.0)
    n_num = torch.clamp(neg_mask.sum(), min=1.0)

    pos_term = ((1.0 - cos) * pos_mask).sum() / p_num
    neg_term = (torch.relu(cos - threshold) * neg_mask).sum() / n_num
    pos_term_t = ((1.0 - cos_t) * pos_mask).sum() / p_num
    neg_term_t = (torch.relu(cos_t - threshold) * neg_mask).sum() / n_num

    loss = pos_term + neg_term + pos_term_t + neg_term_t
    metrics = {"pos": pos_term + pos_term_t, "neg": neg_term + neg_term_t}

    if alpha > 0:
        # multi-label rows only (loss.py:43-45); the reference gathers them,
        # this masks the full B x B similarity matrices instead
        multi = (label.sum(1) > 1).float()                     # [B]
        pair_mask = multi[:, None] * multi[None, :]
        zero_mask = ((label @ label.T) == 0).float() * pair_mask
        n_zero = zero_mask.sum()

        xn, tn = l2_normalize(x), l2_normalize(y)
        denom = torch.clamp(n_zero, min=1.0)
        reg, reg_t, reg_xt = ((alpha * torch.relu(sim - threshold) * zero_mask).sum() / denom
                              for sim in (xn @ xn.T, tn @ tn.T, xn @ tn.T))
        has_zero = (n_zero > 0).float()
        loss = loss + has_zero * (reg + reg_t + reg_xt)
        metrics["reg"] = has_zero * (reg + reg_t + reg_xt)

    return loss, metrics


def init_proxies(gen: torch.Generator, numclass: int, output_dim: int) -> torch.Tensor:
    """kaiming_normal_(randn(C, K), mode='fan_out') (loss.py:15-17):
    std = sqrt(2 / fan_out), fan_out = K for a [C, K] tensor."""
    std = math.sqrt(2.0 / output_dim)
    return std * torch.randn((numclass, output_dim), generator=gen, device=gen.device)
