"""DCHMT loss (MM'22), port of ``ccmh/losses/dchmt.py``
(train/DCHMT/hash_train.py:82-150 of the reference: similarity_loss /
our_loss): intra (i<->t) plus inter (i<->i, t<->t) similarity terms over
cosine or euclidean distance with threshold clipping, l1/l2 reduction.

The thresholds are applied with ``torch.maximum`` / ``torch.minimum``
against tensors, which split the gradient at equality as ``jnp.maximum`` /
``jnp.minimum`` do (``torch.clamp`` would not).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ccmh_torch.config import DCHMTConfig
from ccmh_torch.ops.similarity import calc_neighbor, cosine_similarity, euclidean_similarity


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is +1, as ``jnp.abs``'s is (``torch.abs``
    gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def similarity_loss(a: torch.Tensor, b: torch.Tensor, label_sim: torch.Tensor,
                    mcfg: DCHMTConfig, output_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (positive_loss, negative_loss) for one modality pair."""
    threshold = mcfg.sim_threshold if mcfg.sim_threshold != 0 else 0.05
    if mcfg.similarity_function == "cosine":
        sim = 1.0 - cosine_similarity(a, b)
    else:
        sim = euclidean_similarity(a, b)

    pos = sim * label_sim
    neg = sim * (1.0 - label_sim)

    if mcfg.similarity_function == "cosine":
        pos = torch.maximum(pos, _const(pos, threshold)) - threshold
        neg = torch.minimum(neg, _const(neg, 1.0))
        neg = 1.0 * (1.0 - label_sim) - neg
    else:
        # tolerated distance: half the (doubled, for select pairs) code
        # length times the error rate (hash_train.py:104-107)
        max_value = float(output_dim * 2 * mcfg.vartheta) ** 0.5
        neg = torch.minimum(neg, _const(neg, max_value))
        neg = max_value * (1.0 - label_sim) - neg

    if mcfg.loss_type == "l1":
        return pos.mean(), neg.mean()
    return (pos ** 2).mean(), (neg ** 2).mean()


def dchmt_loss(hash_img: torch.Tensor, hash_txt: torch.Tensor, label: torch.Tensor,
               mcfg: DCHMTConfig, output_dim: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """our_loss (hash_train.py:117-150): intra + inter similarity terms.

    ``hash_img``/``hash_txt``: [B, 2K] flattened select pairs, or [B, K]
    tanh codes in "linear" mode."""
    label_sim = calc_neighbor(label, label)
    ip, inn = similarity_loss(hash_img, hash_txt, label_sim, mcfg, output_dim)
    iip, iin = similarity_loss(hash_img, hash_img, label_sim, mcfg, output_dim)
    ttp, ttn = similarity_loss(hash_txt, hash_txt, label_sim, mcfg, output_dim)
    intra = ip + inn
    inter = iip + iin + ttp + ttn
    loss = intra + inter
    if mcfg.hash_layer != "select":
        # "linear" mode quantization pull toward ±1 (ccmh's stand-in for the
        # reference's undefined self.hash_loss, hash_train.py:131)
        quant = 0.5 * (((_abs(hash_img) - 1.0) ** 2).mean()
                       + ((_abs(hash_txt) - 1.0) ** 2).mean())
        loss = loss + quant
    return loss, {"intra": intra, "inter": inter}
