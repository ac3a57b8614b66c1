"""DDBH boundary-point loss (TCSVT'25).

Port of ``ccmh/losses/ddbh.py`` (train/DDBH/loss.py, BPLoss): per-row
adaptive base points from the similar / dissimilar inner-product
statistics, piecewise sigmoid-mapped DPSH-style likelihoods, as
fixed-shape masked reductions.  The base points are detached, as the
reference's ``.item()`` scalars are.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ccmh_torch.config import DDBHConfig

_BIG = 1e30


def _tail_mean(values: torch.Tensor, mask: torch.Tensor, descending: bool,
               percent: float) -> torch.Tensor:
    """Per-row mean of the sorted masked values from index
    floor(count * percent) to count (loss.py:36, 41): an ascending sort
    gives the top tail, a descending one the bottom tail.  Rows are sorted
    with the unmasked entries pushed past the end; equal values change no
    mean, so ties need no care."""
    n = values.shape[1]
    key = torch.where(mask, values, torch.full_like(values, -_BIG if descending else _BIG))
    s = torch.sort(key, dim=1).values
    if descending:
        s = s.flip(1)
    count = mask.sum(1)
    start = torch.floor(count * percent).long()
    pos = torch.arange(n, device=values.device)[None, :]
    sel = (pos >= start[:, None]) & (pos < count[:, None])
    denom = torch.clamp(count - start, min=1)
    return torch.where(sel, s, torch.zeros_like(s)).sum(1) / denom


def bp_loss(u: torch.Tensor, v: torch.Tensor, y: torch.Tensor, bit: int) -> torch.Tensor:
    y_p, right = 0.5, bit / 6.0
    left = right / 2.0
    lower, upper = 0.0, bit / 4.0
    percent = 9.0 / 10.0

    s = (y @ y.T) > 0                                    # [B, B] incl. self
    inner = u @ v.T
    ns = ~s

    row_ok = s.any(1) & ns.any(1)
    count = torch.clamp(row_ok.sum(), min=1)
    zero = torch.zeros_like(inner)

    def masked_mean(mask):
        return torch.where(mask, inner, zero).sum(1) / torch.clamp(mask.sum(1), min=1)

    meanS = torch.clamp(masked_mean(s), lower, upper)
    meanDS = torch.clamp(masked_mean(ns), lower, upper)
    dis_max = _tail_mean(inner, ns, descending=False, percent=percent)
    sim_min = _tail_mean(inner, s, descending=True, percent=percent)

    BP = meanS - (upper - meanS) / upper * torch.abs(meanS - dis_max)
    BP_ds = meanDS - meanDS / upper * torch.abs(meanDS - sim_min)
    BP = BP.detach()[:, None]                             # .item() in the reference
    BP_ds = BP_ds.detach()[:, None]

    # piecewise sigmoid map parameters (loss.py:91-103); c, a are constants
    c = (1.0 / right) * math.log(y_p / (99.0 * (1.0 - y_p)))
    a = -1.0 / (left * c) * math.log((99.0 * y_p) / (1.0 - y_p))
    d_sim = math.log((1.0 - y_p) / y_p) - c * BP
    g_sim = math.log((1.0 - y_p) / y_p) - a * c * BP
    d_dis = math.log((1.0 - y_p) / y_p) - c * BP_ds
    g_dis = math.log((1.0 - y_p) / y_p) - a * c * BP_ds

    # similar: easy (> BP) uses c*x + d, hard (< BP) uses a*c*x + g;
    # DPSHLoss(True, f) = softplus(f), DPSHLoss(False, f) = softplus(-f)
    sim_easy = s & (inner > BP)
    sim_sel = sim_easy | (s & (inner < BP))
    f_sim = torch.where(sim_easy, c * inner + d_sim, a * c * inner + g_sim)
    sim_loss = (torch.where(sim_sel, F.softplus(f_sim), zero).sum(1)
                / torch.clamp(sim_sel.sum(1), min=1))

    dis_easy = ns & (inner < BP_ds)
    dis_sel = dis_easy | (ns & (inner > BP_ds))
    f_dis = torch.where(dis_easy, c * inner + d_dis, a * c * inner + g_dis)
    dis_loss = (torch.where(dis_sel, F.softplus(-f_dis), zero).sum(1)
                / torch.clamp(dis_sel.sum(1), min=1))

    posL = torch.where(row_ok, sim_loss, torch.zeros_like(sim_loss)).sum() / count
    navL = torch.where(row_ok, dis_loss, torch.zeros_like(dis_loss)).sum() / count
    return posL + navL


def ddbh_loss(hash_img: torch.Tensor, hash_txt: torch.Tensor, label: torch.Tensor,
              mcfg: DDBHConfig, bit: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hash_train.py:68-80: intra i, intra t, inter i-t BP losses +
    similarity-weighted quantization."""
    s = ((label @ label.T) > 0).float()
    intra_i = bp_loss(hash_img, hash_img, label, bit)
    intra_t = bp_loss(hash_txt, hash_txt, label, bit)
    inter = bp_loss(hash_img, hash_txt, label, bit)
    iq = (s @ (hash_img - torch.sign(hash_img)) ** 2).mean()
    tq = (s @ (hash_txt - torch.sign(hash_txt)) ** 2).mean()
    loss = intra_i + intra_t + inter + mcfg.quan_weight * (iq + tq)
    return loss, {"bp": intra_i + intra_t + inter, "quan": iq + tq}
