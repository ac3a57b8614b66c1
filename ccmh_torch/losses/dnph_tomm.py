"""DNPH loss (TOMM'24): proxy loss + class CE + a Hungarian-matched noise
regularizer.  Port of ``ccmh/losses/dnph_tomm.py`` (train/DNPH_TOMM/
{loss.py,b_reg.py}):

* DNPH_out (loss.py:14-31): squared cdist of the concatenated normalised
  codes to the normalised proxies, +1 margin at positive entries,
  ``-label * log_softmax(-D)`` plus cross-entropy on the label-logit heads;
* noise regularizer (b_reg.py:5-41 + hash_train.py:66-81): random ±1
  vectors Hungarian-matched to the batch codes (minimum total L2), then the
  mean inner product of each modality's codes with its matched noise.

The assignment is scipy's ``linear_sum_assignment`` on the host, on the
detached codes' [B, B] cost matrix, one per modality: two device-to-host
copies a step (``ccmh`` runs the same call under ``jax.pure_callback``).
The cost is the norm of the difference in fp32, as ``ccmh`` builds it: an
expanded form could flip a near-tie between distinct noise rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ccmh_torch.ops.similarity import l2_normalize


def init_dnph_proxies(gen: torch.Generator, nclass: int, output_dim: int) -> Dict:
    return {"proxies": torch.randn((nclass, output_dim), generator=gen, device=gen.device) / 8.0}


def _softmax_ce(logits: torch.Tensor, target_idx: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, target_idx[:, None])[:, 0].mean()


def dnph_proxy_loss(feat1: torch.Tensor, feat2: torch.Tensor,
                    pred1: torch.Tensor, pred2: torch.Tensor,
                    label1: torch.Tensor, label2: torch.Tensor,
                    proxies: torch.Tensor, mrg: float = 1.0) -> torch.Tensor:
    feats = l2_normalize(torch.cat([feat1, feat2], dim=0))
    labels = torch.cat([label1, label2], dim=0)
    p = l2_normalize(proxies)
    # squared euclidean distance to the proxies
    d = (feats ** 2).sum(1, keepdim=True) + (p ** 2).sum(1)[None, :] - 2.0 * feats @ p.T
    d = d + mrg * (labels == 1).to(d.dtype)
    p_loss = (-labels * torch.log_softmax(-d, dim=1)).sum(-1).mean()
    d_loss = (_softmax_ce(pred1, label1.argmax(-1))
              + _softmax_ce(pred2, label2.argmax(-1)))
    return p_loss + d_loss


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Column of each row in the minimum-cost assignment."""
    from scipy.optimize import linear_sum_assignment

    _, col = linear_sum_assignment(cost)
    return col


def assign_noise(codes: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Permute the noise rows to minimise the total L2 to the codes
    (b_reg.py:20-41); the codes enter detached."""
    with torch.no_grad():
        cost = torch.linalg.vector_norm(codes.detach()[:, None, :] - noise[None, :, :], dim=-1)
        col = hungarian(cost.float().cpu().numpy())
    return noise[torch.from_numpy(col).to(noise.device)]


def random_signs(generator: Optional[torch.Generator], b: int, k: int,
                 device) -> torch.Tensor:
    """[B, K] uniform ±1 floats (``2 * randint(0, 2) - 1``)."""
    bits = torch.randint(0, 2, (b, k), generator=generator, device=device)
    return (2 * bits - 1).float()


def noise_regularizer(hash_img: torch.Tensor, hash_txt: torch.Tensor,
                      noise: torch.Tensor,
                      assign: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = assign_noise
                      ) -> torch.Tensor:
    """Random ±1 vectors, Hungarian-matched per modality, then the mean
    inner product (hash_train.py:66-78); the caller subtracts it scaled."""
    i_noise = assign(hash_img, noise)
    t_noise = assign(hash_txt, noise)
    return (hash_img * i_noise).sum(-1).mean() + (hash_txt * t_noise).sum(-1).mean()
