"""DHaPH losses (TKDE'24): self-paced multi-similarity + hyperbolic proxies.

Port of ``ccmh/losses/dhaph.py`` (train/DHaPH/{MSLoss.py,HPloss.py,
hp_model.py}):

* :func:`ms_loss` — exp-reweighted contrastive loss with a warm ramp over
  the first third of training; the weights carry no gradient;
* :func:`hp_model` — affine-free LayerNorm (population variance) ->
  Linear -> norm clip (clip_r 2.3) -> expmap0 and projection onto the
  c = 0.1 Poincaré ball, with the Riemannian gradient; it is fed
  *detached* codes (hash_train.py:77-78);
* :func:`hp_loss` — 500 trainable LCA proxies, reciprocal-top-k triplet
  mining, a straight-through Gumbel-softmax (hard) LCA selection and the
  margin hierarchy loss.

``ccmh`` draws the triplets with ``jax.random.categorical`` over logits
masked to -1e30 and the Gumbel noise with ``jax.random.gumbel``.  The port takes both
kinds of draw from a :class:`Draws` (by default Gumbel-max and Gumbel noise
from the step's generator: the same distributions, other bits), so that a
test can hand it ``ccmh``'s own draws.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ccmh_torch.config import DHaPHConfig
from ccmh_torch.losses import pmath
from ccmh_torch.ops.similarity import l2_normalize

Params = Dict[str, torch.Tensor]
_BIG = 1e30
TRIPLETS_PER_ANCHOR = 50   # HPloss.py:171


class Draws:
    """The random draws of :func:`hp_loss`, from one generator in call order."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def gumbel(self, like: torch.Tensor) -> torch.Tensor:
        """Standard Gumbel noise of ``like``'s shape."""
        u = torch.rand(like.shape, generator=self.generator, device=like.device)
        return -torch.log(-torch.log(u))

    def categorical(self, logits: torch.Tensor, n: int) -> torch.Tensor:
        """[R, C] logits -> [R, n] column draws by Gumbel-max.  A row whose
        logits are all -1e30 draws column 0 (the noise vanishes beside
        -1e30 in float32), as ``jax.random.categorical`` does; the miner
        masks such anchors out."""
        noise = self.gumbel(logits[:, None, :].expand(logits.shape[0], n, logits.shape[1]))
        return torch.argmax(logits[:, None, :] + noise, dim=-1)


# ---------------------------------------------------------------------------
# self-paced multi-similarity loss
# ---------------------------------------------------------------------------

def ms_loss(image_feature: torch.Tensor, text_feature: torch.Tensor, labels: torch.Tensor,
            epoch: torch.Tensor, *, temperature: float, total_epoch: int,
            self_paced: bool = True) -> torch.Tensor:
    mask = ((labels @ labels.T) > 0).float()
    dot = l2_normalize(image_feature) @ l2_normalize(text_feature).T
    all_exp = torch.exp(dot / temperature)
    pos_exp = mask * all_exp
    neg_exp = (1.0 - mask) * all_exp

    if self_paced:
        third = max(int(total_epoch / 3), 1)
        e = torch.as_tensor(epoch, device=dot.device).float()
        delta = torch.where(e <= third, e / third, torch.ones_like(e))
        w_pos = torch.exp(-1.0 - dot).detach() ** (delta / 4.0)
        w_neg = torch.exp(-1.0 + dot).detach() ** delta
        pos_exp = pos_exp * w_pos
        neg_exp = neg_exp * w_neg

    pos_sum = pos_exp.sum(1)
    denom = neg_exp.sum(1) + pos_sum
    # a row with no positive pair would take log(0); it is left out, as in ccmh
    has_pos = mask.sum(1) > 0
    floor = torch.tensor(1e-30, dtype=pos_sum.dtype, device=pos_sum.device)
    per_row = torch.where(has_pos, -torch.log(torch.maximum(pos_sum, floor) / denom),
                          torch.zeros_like(pos_sum))
    return per_row.sum() / torch.clamp(has_pos.sum(), min=1)


# ---------------------------------------------------------------------------
# HPmodel: Euclidean -> Poincaré ball
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (2 * torch.rand(shape, generator=gen, device=gen.device) - 1) * bound


def init_hp_model(gen: torch.Generator, bdim: int, emb: int) -> Params:
    bound = 1.0 / math.sqrt(bdim)
    return {"linear": {"w": _uniform(gen, (bdim, emb), bound),
                       "b": _uniform(gen, (emb,), bound)}}


def to_poincare(x: torch.Tensor, c: float, clip_r: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-5
    x = x * torch.minimum(torch.ones_like(norm), clip_r / norm)
    return pmath.riemannian_gradient(pmath.project(pmath.expmap0(x, c), c), c)


def hp_model(p: Params, x: torch.Tensor, mcfg: DHaPHConfig) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)           # jnp.var: population
    x = (x - mean) * torch.rsqrt(var + 1e-5)              # affine-free LayerNorm
    x = x @ p["linear"]["w"] + p["linear"]["b"]
    return to_poincare(x, mcfg.curvature, mcfg.clip_r)


def init_lcas(gen: torch.Generator, mcfg: DHaPHConfig, sz_embed: int) -> torch.Tensor:
    lcas = torch.randn((mcfg.n_proxies, sz_embed), generator=gen, device=gen.device)
    return lcas / math.sqrt(sz_embed) * mcfg.clip_r * 0.9


# ---------------------------------------------------------------------------
# HPLoss
# ---------------------------------------------------------------------------

def _gumbel_softmax_hard(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """F.gumbel_softmax(logits, tau=1, hard=True): straight-through one-hot."""
    soft = torch.softmax(logits + noise, dim=-1)
    hard = torch.nn.functional.one_hot(soft.argmax(-1), logits.shape[-1]).to(soft.dtype)
    return hard + soft - soft.detach()


def _reciprocal_triplets(sim: torch.Tensor, topk: int, t_per_anchor: int, draws: Draws):
    """HPloss.py:162-183: mutual-top-k positives, the rest negatives;
    ``t_per_anchor`` draws per valid anchor (uniform, with replacement)."""
    n = sim.shape[0]
    topk_idx = torch.topk(sim, topk, dim=1).indices
    nn = torch.zeros_like(sim).scatter_(1, topk_idx, 1.0)
    mutual = (nn + nn.T) / 2.0
    mutual = mutual - 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device)
    pos_allowed = mutual == 1.0
    neg_allowed = mutual < 1.0
    anchor_ok = pos_allowed.sum(1) > 1

    zero = torch.zeros((), dtype=sim.dtype, device=sim.device)
    big = torch.full((), -_BIG, dtype=sim.dtype, device=sim.device)
    pos = draws.categorical(torch.where(pos_allowed, zero, big), t_per_anchor)
    neg = draws.categorical(torch.where(neg_allowed, zero, big), t_per_anchor)
    anchors = torch.arange(n, device=sim.device)[:, None].expand(n, t_per_anchor)
    mask = anchor_ok[:, None].expand(n, t_per_anchor)
    return anchors.reshape(-1), pos.reshape(-1), neg.reshape(-1), mask.reshape(-1)


def _compute_ghhc(cp_dist: torch.Tensor, triplets, mrg: float, tau: float,
                  draws: Draws) -> torch.Tensor:
    """HPloss.py:133-159 with a validity mask instead of ragged lists."""
    i, j, k, valid = triplets
    max_ij = torch.maximum(cp_dist[i], cp_dist[j])        # [T, C]
    p_ij = _gumbel_softmax_hard(-max_ij / tau, draws.gumbel(max_ij))
    idx_ij = p_ij.argmax(-1)

    max_ijk = torch.maximum(cp_dist[k], max_ij)
    p_ijk = _gumbel_softmax_hard(-max_ijk / tau, draws.gumbel(max_ijk))
    idx_ijk = p_ijk.argmax(-1)

    def d(row, prob):
        return (cp_dist[row] * prob).sum(1)

    relu = torch.relu
    hc = (relu(d(i, p_ij) - d(i, p_ijk) + mrg)
          + relu(d(j, p_ij) - d(j, p_ijk) + mrg)
          + relu(d(k, p_ijk) - d(k, p_ij) + mrg))
    hc = hc * (idx_ij != idx_ijk) * valid
    return hc.sum() / torch.clamp(valid.sum().to(hc.dtype), min=1.0)


def hp_loss(z_s: torch.Tensor, t_s: torch.Tensor, y: torch.Tensor, lcas_raw: torch.Tensor,
            mcfg: DHaPHConfig, draws: Draws) -> torch.Tensor:
    """HPLoss.forward (HPloss.py:185-221)."""
    bs = z_s.shape[0]
    c, tau, mrg = mcfg.curvature, mcfg.temperature, 0.1
    hot = ((y @ y.T) > 0).to(z_s.dtype)
    lcas = to_poincare(lcas_raw, c, mcfg.clip_r)

    def dists(feats):
        nodes = torch.cat([feats, lcas])
        return pmath.dist_matrix(nodes, nodes, c)

    loss = z_s.new_zeros(())
    for dm in (dists(z_s), dists(t_s)):
        sim = torch.exp(-dm[:bs, :bs]).detach() + hot
        sim2 = torch.exp(-dm[bs:, bs:]).detach()
        for cp_dist, s in ((dm[:bs, bs:], sim), (dm[bs:, bs:], sim2)):
            triplets = _reciprocal_triplets(s, mcfg.topk, TRIPLETS_PER_ANCHOR, draws)
            loss = loss + _compute_ghhc(cp_dist, triplets, mrg, tau, draws)
    return loss


def dhaph_loss(hash_img: torch.Tensor, hash_txt: torch.Tensor, label: torch.Tensor,
               extra: Params, epoch: torch.Tensor, mcfg: DHaPHConfig, total_epoch: int,
               draws: Draws, alpha: float = 1.0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hash_train.py:70-84: 3x self-paced MS + alpha x the hyperbolic proxy
    loss on detached codes through HPmodel."""
    e = epoch + 1
    kw = dict(temperature=0.3, total_epoch=total_epoch)
    l1 = ms_loss(hash_img, hash_img, label, e, **kw)
    l2 = ms_loss(hash_txt, hash_txt, label, e, **kw)
    l3 = ms_loss(hash_img, hash_txt, label, e, **kw)

    hp_img = hp_model(extra["hpmodel"], hash_img.detach(), mcfg)
    hp_txt = hp_model(extra["hpmodel"], hash_txt.detach(), mcfg)
    l4 = hp_loss(hp_img, hp_txt, label, extra["lcas"], mcfg, draws)
    return l1 + l2 + l3 + alpha * l4, {"ms": l1 + l2 + l3, "hp": l4}
