"""DMsH-LN loss (Neurocomputing'24): LabelNet + multi-similarity mining.

Port of ``ccmh/losses/dmsh_ln.py`` (train/DMsH_LN/{MSLOSS.py,labelnet.py}):

* LabelNet: label -> code MLP with the epoch-annealed tanh sharpness
  alpha = sqrt(epoch + 1) (labelnet.py:6-22);
* MultiSimilarityLoss (MSLOSS.py:4-56): per-row pair mining over the
  row-normalized similarity matrix, positives by the sign of label-code
  inner products, exp-weighted log-sum losses, as fixed-shape masked
  reductions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ccmh_torch.config import DMsHLNConfig
from ccmh_torch.ops.similarity import l2_normalize

_BIG = 1e30


def init_label_net(gen: torch.Generator, label_dim: int, code_len: int) -> Dict:
    hidden = (label_dim + code_len) // 2

    def linear(i, o):
        bound = 1.0 / math.sqrt(i)
        w = (2 * torch.rand((i, o), generator=gen, device=gen.device) - 1) * bound
        b = (2 * torch.rand((o,), generator=gen, device=gen.device) - 1) * bound
        return {"w": w, "b": b}

    return {"fc1": linear(label_dim, hidden), "fc2": linear(hidden, code_len)}


def label_net(p: Dict, label: torch.Tensor, epoch: torch.Tensor) -> torch.Tensor:
    alpha = torch.sqrt(epoch.float() + 1.0)
    feat = torch.relu(label @ p["fc1"]["w"] + p["fc1"]["b"])
    hid = feat @ p["fc2"]["w"] + p["fc2"]["b"]
    return torch.tanh(alpha * hid)


def multi_similarity_loss(feats: torch.Tensor, label_codes: torch.Tensor,
                          mcfg: DMsHLNConfig, feat2: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """MSLOSS.py:13-56 with masked (fixed-shape) mining."""
    other = feats if feat2 is None else feat2
    # F.normalize over dim=1: each ROW of the similarity matrix to unit norm
    sim = l2_normalize(feats @ other.T, dim=1)

    pos_label = (label_codes @ label_codes.T) > 0            # [B, B] bool
    pos_mask = pos_label & (sim < 1 - 1e-5)
    neg_mask = ~pos_label

    min_pos = torch.where(pos_mask, sim, torch.full_like(sim, _BIG)).amin(1)    # +big if none
    max_neg = torch.where(neg_mask, sim, torch.full_like(sim, -_BIG)).amax(1)   # -big if none

    mined_neg = neg_mask & (sim + mcfg.ms_margin > min_pos[:, None])
    mined_pos = pos_mask & (sim - mcfg.ms_margin < max_neg[:, None])

    valid = pos_mask.any(1) & neg_mask.any(1) & mined_neg.any(1) & mined_pos.any(1)

    sp, sn, th = mcfg.scale_pos, mcfg.scale_neg, mcfg.ms_thresh
    zero = torch.zeros_like(sim)
    pos_exp = torch.where(mined_pos, torch.exp(-sp * (sim - th)), zero)
    neg_exp = torch.where(mined_neg, torch.exp(sn * (sim - th)), zero)
    pos_loss = torch.log1p(pos_exp.sum(1)) / sp
    neg_loss = torch.log1p(neg_exp.sum(1)) / sn

    per_row = pos_loss + neg_loss
    return torch.where(valid, per_row, torch.zeros_like(per_row)).sum() / feats.shape[0]


def dmsh_ln_loss(hash_img: torch.Tensor, hash_txt: torch.Tensor, label: torch.Tensor,
                 label_net_params: Dict, epoch: torch.Tensor, mcfg: DMsHLNConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hash_train.py:62-67: MSL(img, L), MSL(txt, L), MSL(img, L, feat2=txt)."""
    codes = label_net(label_net_params, label, epoch)
    li = multi_similarity_loss(hash_img, codes, mcfg)
    lt = multi_similarity_loss(hash_txt, codes, mcfg)
    lit = multi_similarity_loss(hash_img, codes, mcfg, feat2=hash_txt)
    return li + lt + lit, {"img": li, "txt": lt, "i_t": lit}
