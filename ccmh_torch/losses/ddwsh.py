"""DDWSH loss (TMM'26): margin loss with distance-weighted negative mining.

Port of ``ccmh/losses/ddwsh.py`` (train/DDWSH/loss.py, repaired there):

* distances for the loss: cdist of L2-normalized codes, floored at 1e-8;
* the miner receives the detached distance matrix as its feature matrix
  (loss.py:22 passes cdist to a sampler that calls pdist on it), as in
  ``ccmh``;
* negatives ~ q(d) ∝ d^(2-n) (1 - d²/4)^-((n-3)/2), same-label zeroed;
  positives uniform over the other same-label rows;
* anchors with < 2 positives or all-positive rows are masked;
* loss = sum(relu(d_ap - beta + margin) + relu(beta - d_an + margin)) /
  #active pairs, beta per anchor = label-weighted mean of class betas.

``ccmh`` draws with ``jax.random.categorical`` over rows masked to -1e30.
``torch.multinomial`` raises on a row of zero probabilities, which an
anchor without a positive produces (``anchor_ok`` masks it afterwards), so
the port draws by Gumbel-max from the step's generator (:func:`gumbel_max`,
the same distribution, other bits).  The loss takes the sampler as an
argument, so a test can hand it ``ccmh``'s own draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ccmh_torch.config import DDWSHConfig
from ccmh_torch.ops.similarity import euclidean_similarity, l2_normalize

_BIG = 1e30

# logits [B, B] -> one column index per row [B]
Sampler = Callable[[torch.Tensor], torch.Tensor]


def gumbel_max(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row: ``argmax(logits + Gumbel noise)``.  A
    row whose logits are all -1e30 still yields an index (any column)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def _pdist(a: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    prod = a @ a.T
    norm = torch.diagonal(prod)[:, None]
    sq = torch.clamp(norm + norm.T - 2.0 * prod, min=0.0)
    return torch.sqrt(torch.clamp(sq, min=eps))


def margin_loss(codes: torch.Tensor, labels: torch.Tensor, extra: Dict, mcfg: DDWSHConfig,
                sample: Sampler, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One margin loss; ``sample`` draws the positive, then the negative."""
    batch = l2_normalize(codes)
    other = batch if y is None else l2_normalize(y)
    b = batch.shape[0]

    e = euclidean_similarity(batch, other)
    cdist = torch.maximum(e, e.new_tensor(1e-8))                       # [B, B]

    # distance-weighted sampling over pdist(cdist) (loss.py:101-122); no
    # gradient flows through the draws
    with torch.no_grad():
        d = torch.clamp(_pdist(cdist.detach()), min=mcfg.cutoff)
        dim = float(b)  # the miner's "feature dim" is B (it sees the B x B matrix)
        A = torch.clamp(1.0 - 0.25 * d * d, min=1e-8)
        log_q = (2.0 - dim) * torch.log(d) - ((dim - 3.0) / 2.0) * torch.log(A)

        same = (labels @ labels.T) > 0                                 # [B, B]
        pos_count = same.sum(1)                                        # incl. self
        anchor_ok = ((pos_count > 1) & (pos_count != b)).float()

        big = torch.full_like(log_q, -_BIG)
        log_q = torch.where(same, big, log_q)                          # zero same-class prob
        eye = torch.eye(b, dtype=torch.bool, device=codes.device)
        pos_logits = torch.where(same & ~eye, torch.zeros_like(log_q), big)
        pos_idx = sample(pos_logits)                                   # uniform positive
        neg_idx = sample(log_q)

    d_ap = cdist.gather(1, pos_idx[:, None].long())[:, 0]
    d_an = cdist.gather(1, neg_idx[:, None].long())[:, 0]

    # per-anchor beta: label-weighted mean of class betas (loss.py:36-37)
    beta = (labels @ extra["beta"]) / torch.clamp(labels.sum(1), min=1.0)

    pos_loss = torch.relu(d_ap - beta + mcfg.margin) * anchor_ok
    neg_loss = torch.relu(beta - d_an + mcfg.margin) * anchor_ok
    pair_count = ((pos_loss > 0).float() + (neg_loss > 0).float()).sum()
    total = (pos_loss + neg_loss).sum()
    return torch.where(pair_count > 0, total / torch.clamp(pair_count, min=1.0), total)


def ddwsh_loss(hash_img: torch.Tensor, hash_txt: torch.Tensor, label: torch.Tensor,
               extra: Dict, mcfg: DDWSHConfig, sample: Sampler
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hash_train.py:66-68: criterion(i), criterion(t), criterion(i, y=t)."""
    li = margin_loss(hash_img, label, extra, mcfg, sample)
    lt = margin_loss(hash_txt, label, extra, mcfg, sample)
    lit = margin_loss(hash_img, label, extra, mcfg, sample, y=hash_txt)
    return li + lt + lit, {"img": li, "txt": lt, "i_t": lit}


def init_ddwsh_extra(nclass: int, beta_init: float, device=None) -> Dict:
    return {"beta": torch.full((nclass,), beta_init, device=device)}
