"""DGHDGH (ICLR'26): GNN-synthesized hard negatives, as ``ccmh``
reconstructs it (the reference imports three modules it does not ship:
docs/dghdgh_reconstruction.md).  Port of ``ccmh/losses/dghdgh.py``.

* stage 2 (model + GNN): J_r (the 4-way triplet loss) + J_gca (the GNN's
  node-classification CE) + adaptive-λ3 · J_syn (the triplet loss against
  GNN-gated synthetic hard negatives, GeneralPulling loss.py:18-67);
* the classifier: CE on detached embeddings;
* stage 1 (GNN): J_ce (classify the synthetic embeddings) + J_sim
  (anchor-synthetic cosine) + J_div (edge-representation diversity).

The reconstructed parts are ``ccmh``'s: a fixed-shape triplet sampler
(T_PER_ANCHOR draws per anchor over the label match / differ masks), a
fully connected batch graph with edge features [z_i ⊙ r_j, |z_i − r_j|],
and attention-weighted message passing with a sigmoid edge gate in the
last layer.  ``ccmh`` draws the triplets with ``jax.random.categorical``;
the port draws by Gumbel-max from the step's generator (the same
distribution, other bits) through a sampler argument, so that a test can
hand over ``ccmh``'s draws.  A row with nothing allowed draws column 0 and
its triplets are masked by ``valid``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ccmh_torch.config import DGHDGHConfig
from ccmh_torch.losses.ddwsh import gumbel_max
from ccmh_torch.models.heads import init_pre_layer as _linear_init
from ccmh_torch.ops.similarity import l2_normalize

_BIG = 1e30
T_PER_ANCHOR = 32   # the reconstruction's fixed triplet budget per anchor

# logits [B, B], T -> [B, T] column draws per row
Sampler = Callable[[torch.Tensor, int], torch.Tensor]
Triplets = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def gumbel_sampler(generator: Optional[torch.Generator]) -> Sampler:
    """T categorical draws per row, by Gumbel-max."""
    def sample(logits: torch.Tensor, t: int) -> torch.Tensor:
        b = logits.shape[0]
        return gumbel_max(logits.repeat_interleave(t, dim=0), generator).reshape(b, t)
    return sample


def init_gnn(gen: torch.Generator, n_bits: int, n_classes: int, hidden: int = 0,
             n_layers: int = 2, n_heads: int = 4) -> Dict:
    """``n_layers`` message-passing rounds of ``n_heads`` attention heads
    (loss.py:76-77, get_args.py:11-12)."""
    if n_bits % n_heads:
        raise ValueError(f"output_dim {n_bits} must divide by dghdgh.n_heads {n_heads}")
    hidden = hidden or 2 * n_bits
    layers = [{"edge_mlp": {"fc1": _linear_init(gen, 2 * n_bits, hidden),
                            "fc2": _linear_init(gen, hidden, n_bits)},
               "attn": _linear_init(gen, 2 * n_bits, n_heads),
               "node_mlp": _linear_init(gen, 2 * n_bits, n_bits)}
              for _ in range(n_layers)]
    return {"layers": layers, "classifier": _linear_init(gen, n_bits, n_classes)}


def init_softmax_classifier(gen: torch.Generator, n_bits: int, n_classes: int) -> Dict:
    return _linear_init(gen, n_bits, n_classes)


def _lin(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


class GnnOut(NamedTuple):
    nodes: torch.Tensor        # [B, K] updated node states
    node_preds: torch.Tensor   # [B, C] class logits
    edge_reprs: torch.Tensor   # [B, B, K] sigmoid gates λij


def gnn_forward(p: Dict, z: torch.Tensor, ref: torch.Tensor) -> GnnOut:
    """Nodes ``z`` aggregate messages from ``ref`` over the fully connected
    graph in every layer; the last layer's sigmoid edge output is the λij
    gate that GeneralPulling reads."""
    b, k = z.shape
    cur = z
    edge_reprs = None
    for layer in p["layers"]:
        prod = cur[:, None, :] * ref[None, :, :]                        # [B, B, K]
        diff = torch.abs(cur[:, None, :] - ref[None, :, :])
        edge_in = torch.cat([prod, diff], dim=-1)                       # [B, B, 2K]
        h = torch.relu(_lin(layer["edge_mlp"]["fc1"], edge_in))
        edge_reprs = torch.sigmoid(_lin(layer["edge_mlp"]["fc2"], h))
        weights = torch.softmax(_lin(layer["attn"], edge_in), dim=1)    # [B, B, H]
        n_heads = weights.shape[-1]
        values = (edge_reprs * ref[None, :, :]).reshape(b, b, n_heads, k // n_heads)
        messages = torch.einsum("bnh,bnhd->bhd", weights, values).reshape(b, k)
        cur = torch.tanh(_lin(layer["node_mlp"], torch.cat([cur, messages], -1)))
    return GnnOut(cur, _lin(p["classifier"], cur), edge_reprs)


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss with float (multi-hot) targets."""
    return (-targets * torch.log_softmax(logits, -1)).sum(-1).mean()


def gen_triplets(labels: torch.Tensor, sample: Sampler, cross: bool = False) -> Triplets:
    """(anchors, positives, negatives, valid), T_PER_ANCHOR per anchor over
    the label match / differ masks; the same-set case excludes the
    diagonal.  ``sample`` draws the positives, then the negatives."""
    b = labels.shape[0]
    same = (labels @ labels.T) > 0
    eye = torch.eye(b, dtype=torch.bool, device=labels.device)
    pos_allowed = same if cross else (same & ~eye)
    neg_allowed = ~same
    zero = torch.zeros((), device=labels.device)
    big = torch.full((), -_BIG, device=labels.device)
    with torch.no_grad():
        pos = sample(torch.where(pos_allowed, zero, big), T_PER_ANCHOR)
        neg = sample(torch.where(neg_allowed, zero, big), T_PER_ANCHOR)
    anchors = torch.arange(b, device=labels.device)[:, None].expand(b, T_PER_ANCHOR)
    ok = pos_allowed.any(1) & neg_allowed.any(1)
    valid = ok[:, None].expand(b, T_PER_ANCHOR)
    return (anchors.reshape(-1), pos.reshape(-1).long(), neg.reshape(-1).long(),
            valid.reshape(-1))


def _masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    count = mask.sum()
    total = torch.where(mask, vals, torch.zeros_like(vals)).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), torch.zeros_like(total))


def triplet_loss(emb, ref, triplets: Triplets, margin: float = 0.25, neg_embs=None,
                 hardness: str = "all") -> torch.Tensor:
    """loss.py:84-107: the inner-product triplet loss, optionally against
    synthetic negatives."""
    a, p, n, valid = triplets
    sim = emb @ ref.T
    s_ap = sim[a, p]
    if neg_embs is None:
        s_an = sim[a, n]
    else:
        s_an = (l2_normalize(emb[a]) * l2_normalize(neg_embs)).sum(-1)
    losses = torch.relu(s_an - s_ap + margin)
    mask = (losses > 0) & valid
    if hardness == "semi":
        mask = mask & (s_ap >= s_an)
    elif hardness == "hard":
        mask = mask & (s_ap < s_an)
    return _masked_mean(losses, mask)


def _floor(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.maximum(x, torch.tensor(eps, dtype=x.dtype, device=x.device))


def _cdist(a, b):
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    return torch.sqrt(_floor(a2 + b2.T - 2 * a @ b.T, 1e-12))


def _meter(j_avg: torch.Tensor) -> torch.Tensor:
    """A running mean with its empty value 0 read as 1e6."""
    return torch.where(j_avg == 0, torch.full_like(j_avg, 1e6), j_avg)


def general_pulling(emb, ref, triplets: Triplets, edge_reprs, j_avg, alpha: float):
    """GeneralPulling (loss.py:18-67): gated interpolation toward the
    negatives."""
    a, p, n, _ = triplets
    d = _floor(_cdist(emb, ref), 1e-6)
    d_ap, d_an = d[a, p], d[a, n]
    lam_eta = edge_reprs[a, n, :] * torch.exp(-alpha / _meter(j_avg))      # [T, K]
    r = (1 - lam_eta) * (d_ap / d_an)[:, None] + lam_eta
    z_i, z_j = emb[a], ref[n]
    z_tile = (1 - r) * z_i + r * z_j
    return torch.where((d_ap >= d_an)[:, None], z_j, z_tile)


def _four(zi, zt, ii_tt, it_ti):
    """The four (emb, ref, triplets) pairings: ii, it, ti, tt."""
    return {"ii": (zi, zi, ii_tt), "it": (zi, zt, it_ti), "ti": (zt, zi, it_ti),
            "tt": (zt, zt, ii_tt)}


def stage2_losses(zi, zt, label, gnn_params, ii_tt, it_ti, j_r_avg, mcfg: DGHDGHConfig):
    """fwd_stage2 (loss.py:108-174): (J_r, J_gca, J_syn).  ``j_r_avg`` is
    the running J_r mean before this step; the edge gates enter
    GeneralPulling detached (loss.py:160-163)."""
    alpha, margin = mcfg.alpha, mcfg.margin
    pairs = _four(zi, zt, ii_tt, it_ti)
    j_r = sum(triplet_loss(e, r, t, margin) for e, r, t in pairs.values()) / 4
    outs = {k: gnn_forward(gnn_params, e, r) for k, (e, r, _) in pairs.items()}
    j_gca = sum(soft_ce(o.node_preds, label) for o in outs.values()) / 4
    j_syn = sum(triplet_loss(e, r, t, margin, hardness="hard", neg_embs=general_pulling(
        e, r, t, outs[k].edge_reprs.detach(), j_r_avg, alpha))
        for k, (e, r, t) in pairs.items()) / 4
    return j_r, j_gca, j_syn


def adaptive_lambda3(j_gen_avg: torch.Tensor, beta: float) -> torch.Tensor:
    """λ3 = 1 - exp(-β / J_gen_avg), clamped to [0.1, 0.9] and then reset
    to 0.1 unless it is exactly 0.1 or 0.9 (hash_train.py:95-101): 0.9 when
    the raw value reaches 0.9, else 0.1."""
    raw = 1.0 - torch.exp(-beta / _meter(j_gen_avg))
    return torch.where(raw >= 0.9, torch.full_like(raw, 0.9), torch.full_like(raw, 0.1))


def classifier_ce(cls_params, zi, zt, label) -> torch.Tensor:
    """J_cz (hash_train.py:113-116) on the detached embeddings."""
    return (soft_ce(_lin(cls_params, zi), label) + soft_ce(_lin(cls_params, zt), label)) / 2


def stage1_losses(zi, zt, label, gnn_params, cls_params, ii_tt, it_ti, j_r_avg,
                  mcfg: DGHDGHConfig):
    """fwd_stage1 (loss.py:190-281): (J_ce, J_sim, J_div) on detached
    embeddings (the caller detaches them).  The edge gates are not detached
    here; the classifier's weights are."""
    pairs = _four(zi, zt, ii_tt, it_ti)
    outs = {k: gnn_forward(gnn_params, e, r) for k, (e, r, _) in pairs.items()}
    syn = {k: general_pulling(e, r, t, outs[k].edge_reprs, j_r_avg, mcfg.alpha)
           for k, (e, r, t) in pairs.items()}
    w, b = cls_params["w"].detach(), cls_params["b"].detach()
    # triplets of anchors with no eligible positive or negative carry
    # placeholder indices; ``valid`` masks them out
    j_ce = sum(_masked_mean((-label[t[2]] * torch.log_softmax(syn[k] @ w + b, -1)).sum(-1), t[3])
               for k, (_, _, t) in pairs.items()) / 4
    j_sim = sum(_masked_mean(1 - (l2_normalize(e[t[0]]) * l2_normalize(syn[k])).sum(-1), t[3])
                for k, (e, _, t) in pairs.items()) / 4

    def div_term(o):
        e = o.edge_reprs                                                  # [B, B, K]
        spread = ((e - e.mean(1, keepdim=True)) ** 2).sum(-1).mean()
        return 1.0 - torch.sqrt(_floor(spread, 1e-12))
    j_div = sum(div_term(o) for o in outs.values()) / 4
    return j_ce, j_sim, j_div


def dghdgh_loss(embed_i: torch.Tensor, embed_t: torch.Tensor, label: torch.Tensor,
                gnn_params: Dict, cls_params: Dict, j_r_avg: torch.Tensor,
                j_gen_avg: torch.Tensor, mcfg: DGHDGHConfig, sample: Sampler
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The fused one-step form of the reference's three backward passes
    (hash_train.py:75-130): the detaches route J_m to the model and the
    GNN, J_cz to the classifier, J_gen to the GNN.  The three-phase
    sequencing is ``dghdgh.sequenced`` (train/methods/dghdgh.py)."""
    zi, zt = l2_normalize(embed_i), l2_normalize(embed_t)
    ii_tt = gen_triplets(label, sample)
    it_ti = gen_triplets(label, sample, cross=True)
    j_r, j_gca, j_syn = stage2_losses(zi, zt, label, gnn_params, ii_tt, it_ti, j_r_avg, mcfg)
    lam3 = adaptive_lambda3(j_gen_avg, mcfg.beta)
    j_m = mcfg.lambda1 * j_r + mcfg.lambda2 * j_gca + lam3.detach() * j_syn
    zi_d, zt_d = zi.detach(), zt.detach()
    j_cz = classifier_ce(cls_params, zi_d, zt_d, label)
    j_ce, j_sim, j_div = stage1_losses(zi_d, zt_d, label, gnn_params, cls_params, ii_tt,
                                       it_ti, j_r_avg, mcfg)
    j_gen = mcfg.lambda5 * j_ce + mcfg.lambda6 * j_sim + mcfg.lambda7 * j_div
    loss = j_m + mcfg.lambda4 * j_cz + j_gen
    return loss, {"J_r": j_r, "J_gca": j_gca, "J_syn": j_syn, "J_cz": j_cz,
                  "J_gen": j_gen, "lambda3": lam3}
