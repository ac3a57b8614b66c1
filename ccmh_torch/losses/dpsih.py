"""DPSIH losses (AAAI'26): multi-semantic-correlation triplets and the
auxiliary multi-embed regularizers.

Port of ``ccmh/losses/dpsih.py`` (train/DPSIH/Loss.py):

* :func:`msc_loss` (:81-137): the negated (max-pooled over the embed pairs)
  inner-product similarity, every (anchor, positive, negative) triplet of
  the label overlap, "all" mining (the margin-violating triplets), the
  mean violation; the ragged triplet lists become a masked [B, B, B]
  violation tensor, the same sum;
* :func:`rbf_mmd_loss` (:53-57) and :func:`embedding_diversity_loss`
  (:45-51) for num_embeds > 1, both with the batch SUM reduction: the
  reference passes the device rank as ``reduction`` (hash_train.py:49,
  Loss.py:29), so its sum branch runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ccmh_torch.config import DPSIHConfig
from ccmh_torch.models.dpsih import l2norm


def _pooled_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-embed [B, E, K] pairs -> [B, M] max inner product over E x E
    (Loss.py:100-104; ``amax`` splits the gradient among ties as
    ``jnp.max`` does); 2-D inputs use the plain inner product."""
    if a.ndim == 2:
        return a @ b.T
    return torch.einsum("aek,bfk->abef", a, b).amax(dim=(2, 3))


def msc_loss(batch_inputs: torch.Tensor, batch_labels: torch.Tensor,
             inputs: Optional[torch.Tensor] = None, margin: float = 0.25) -> torch.Tensor:
    other = batch_inputs if inputs is None else inputs
    sim_mat = -_pooled_sim(batch_inputs, other)            # [B, M]
    sames = (batch_labels @ batch_labels.T) > 0
    diffs = ~sames
    if sim_mat.shape[0] == sim_mat.shape[1]:
        sames = sames & ~torch.eye(sames.shape[0], dtype=torch.bool, device=sames.device)
    # triplets (a, p, n): ap from sim[a, p], an from sim[a, n]
    valid = sames[:, :, None] & diffs[:, None, :]          # [B, M, M]
    viol = sim_mat[:, :, None] - sim_mat[:, None, :] + margin
    sel = valid & (viol >= 0)                              # mining "all"
    count = sel.sum()
    total = torch.where(sel, viol, torch.zeros_like(viol)).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), torch.zeros_like(total))


def rbf_mmd_loss(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    def rbf(a, b):
        diff = a[:, None, :] - b[None, :, :]
        sq = (diff * diff).sum(-1)
        # a zero-safe distance: the (x, x) diagonal is exactly 0, where a
        # plain sqrt would give a NaN gradient
        is_zero = sq < 1e-24
        d = torch.where(is_zero, torch.zeros_like(sq),
                        torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))
        return torch.exp(-gamma * d)
    return (rbf(x, x) - 2 * rbf(x, y) + rbf(y, y)).sum()


def embedding_diversity_loss(x: torch.Tensor, num_embeds: int) -> torch.Tensor:
    """The off-diagonal norm of each item's embed gram [B, E, E] over the
    residuals (Loss.py:45-51), summed over the batch."""
    xn = l2norm(x)
    gram = torch.einsum("bek,bfk->bef", xn, xn)
    gram = gram * (1.0 - torch.eye(gram.shape[1], device=gram.device))
    return torch.linalg.vector_norm(gram.reshape(gram.shape[0], -1), dim=1).sum() / num_embeds ** 2


def dpsih_loss(img: torch.Tensor, txt: torch.Tensor, img_r: torch.Tensor, txt_r: torch.Tensor,
               label: torch.Tensor, mcfg: DPSIHConfig, num_embeds: int = 4,
               alpha1: float = 0.01, alpha2: float = 0.01
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss.py:59-77."""
    msc = (msc_loss(img, label, margin=mcfg.margin)
           + msc_loss(txt, label, margin=mcfg.margin)
           + msc_loss(img, label, inputs=txt, margin=mcfg.margin))
    loss = msc * mcfg.msc_weight
    metrics = {"msc": msc}
    if num_embeds > 1 and alpha1 > 0:
        dc = rbf_mmd_loss(img.reshape(-1, img.shape[-1]), txt.reshape(-1, txt.shape[-1]),
                          gamma=0.5)
        loss = loss + alpha1 * dc
        metrics["dc"] = dc
    if num_embeds > 1 and alpha2 > 0:
        ed = embedding_diversity_loss(img_r, num_embeds) + embedding_diversity_loss(txt_r, num_embeds)
        loss = loss + alpha2 * ed
        metrics["ed"] = ed
    return loss, metrics
