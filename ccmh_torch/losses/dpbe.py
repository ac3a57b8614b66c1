"""DPBE Laplace-approximation Bayesian hashing (MM'25).  Port of
``ccmh/losses/dpbe.py`` (train/DPBE/hash_train.py:89-258 and the parts of
the vendored stochman library the method uses):

* a diagonal Laplace posterior over the Linear->L2Norm head weights:
  sigma = 1 / (sqrt(relu(H) + 1) + 1e-6), theta = mu + eps * sigma, the
  gradient reaching mu only;
* the closed-form diagonal GGN of Linear->L2Norm,
  diag M_jj = (1 - (2 - s) yhat_j^2) / (n + eps)^2,
  H[W_jk] = mean_b M_jj x_k^2, H[b_j] = mean_b M_jj;
* affinity targets 2 * sigmoid(label @ label^T) - 1;
* the Hessian scaled by N^2 / b, b = the reference miner's triplet count
  capped at max_pairs (:func:`n_triplets`, exact in integers).

``ccmh`` vmaps the loss over the posterior samples; the port loops over
them.  Every normal draw goes through a ``draw(shape) -> tensor``
callable, sample by sample, image head then text head, w then b in each,
so that a test can hand the port ``ccmh``'s own draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
EPS = 1e-6

# shape -> one standard-normal tensor of that shape
Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def normal_draw(generator: Optional[torch.Generator], device) -> Draw:
    return lambda shape: torch.randn(shape, generator=generator, device=device)


def l2norm_head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"] + p["b"]
    return y / (torch.linalg.vector_norm(y, dim=1, keepdim=True) + EPS)


def head_ggn_diag(p: Params, x: torch.Tensor) -> Params:
    """The closed-form diagonal GGN of Linear->L2Norm wrt (w, b), batch mean."""
    y = x @ p["w"] + p["b"]                                    # [B, K]
    n = torch.linalg.vector_norm(y, dim=1, keepdim=True)       # [B, 1]
    yhat = y / (n + EPS)
    s = (yhat * yhat).sum(1, keepdim=True)
    m_diag = (1.0 - (2.0 - s) * yhat ** 2) / (n + EPS) ** 2    # [B, K]
    h_w = (x * x).T @ m_diag / x.shape[0]                      # [D, K]
    return {"w": h_w, "b": m_diag.mean(0)}


def posterior_scale(hessian: Params, prior_prec: float = 1.0) -> Params:
    return {k: 1.0 / (torch.sqrt(torch.relu(h) + prior_prec) + 1e-6) for k, h in hessian.items()}


def sample_head(mu: Params, sigma: Params, draw: Draw) -> Params:
    """One posterior weight sample, w then b; the gradient reaches mu only."""
    return {k: mu[k] + (draw(tuple(mu[k].shape)) * sigma[k]).detach() for k in ("w", "b")}


def affinity_targets(label: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sigmoid(label @ label.T) - 1.0


def n_triplets(label: torch.Tensor) -> torch.Tensor:
    """The (anchor, pos, neg) count of the reference's TripletMinner
    (train/DPBE/triplet_miner.py:5-38), quirks included: ``matches = (L @
    L^T).byte()`` keeps the overlap count mod 256, ``diffs = matches ^ 1``
    is nonzero for overlap 0 and any overlap >= 2, and the triplet tensor
    is the uint8 product ``matches[a, p] * diffs[a, n]``, so products that
    are nonzero multiples of 256 wrap to 0 and drop out of the count.

    A uint8 product is 0 mod 256 iff v2(x) + v2(y) >= 8 (v2 the 2-adic
    valuation, v2(0) taken as 8), so per-anchor 9-bin histograms of v2 of
    the matches and of the diffs give the count without the [B, B, B]
    tensor.  int64 throughout; an int64 scalar."""
    m = torch.round(label.double() @ label.double().T).long() % 256
    d = m ^ 1

    def v2(x):   # trailing zero bits of a byte, 8 for 0
        return sum((x % (1 << j) == 0).long() for j in range(1, 9))

    hist_m = torch.nn.functional.one_hot(v2(m), 9).sum(1)       # [B, 9]
    hist_d = torch.nn.functional.one_hot(v2(d), 9).sum(1)
    i = torch.arange(9, device=label.device)
    nonzero = (i[:, None] + i[None, :] < 8).long()
    # elementwise: CUDA has no integer matmul
    return (hist_m[:, :, None] * hist_d[:, None, :] * nonzero).sum()


def dpbe_sampled_loss(embed_i: torch.Tensor, embed_t: torch.Tensor, label: torch.Tensor,
                      mu_i: Params, mu_t: Params, hessian_i: Params, hessian_t: Params,
                      draw: Draw, *, n_samples: int, max_pairs: int, train_num: int
                      ) -> Tuple[torch.Tensor, Params, Params]:
    """-> (mean loss over the posterior samples, batch hessian_i, hessian_t);
    the Hessians carry no gradient."""
    aff = affinity_targets(label)
    sigma_i = posterior_scale({k: torch.relu(h) for k, h in hessian_i.items()})
    sigma_t = posterior_scale({k: torch.relu(h) for k, h in hessian_t.items()})
    b = torch.clamp(n_triplets(label), max=max_pairs).float()
    scale = (train_num ** 2) / torch.clamp(b, min=1.0)

    losses, h_is, h_ts = [], [], []
    for _ in range(n_samples):
        theta_i = sample_head(mu_i, sigma_i, draw)
        theta_t = sample_head(mu_t, sigma_t, draw)
        z_i = l2norm_head_apply(theta_i, embed_i)
        z_t = l2norm_head_apply(theta_t, embed_t)
        losses.append(((z_i @ z_i.T - aff) ** 2).mean() + ((z_t @ z_t.T - aff) ** 2).mean()
                      + ((z_i @ z_t.T - aff) ** 2).mean())
        with torch.no_grad():
            for out, theta, x in ((h_is, theta_i, embed_i), (h_ts, theta_t, embed_t)):
                out.append({k: h * scale for k, h in
                            head_ggn_diag({k: v.detach() for k, v in theta.items()},
                                          x.detach()).items()})

    def mean(hs):
        return {k: torch.stack([h[k] for h in hs]).mean(0) for k in hs[0]}
    return torch.stack(losses).mean(), mean(h_is), mean(h_ts)


def dpbe_encode_codes(embed: torch.Tensor, mu: Params, hessian: Params,
                      draws) -> torch.Tensor:
    """Eval: the mean of one head's normalised codes over its posterior
    samples, before the sign (hash_train.py:214-242); ``draws`` holds one
    {"w", "b"} noise dict a sample.  ``ccmh`` encodes both heads in one
    call; the port encodes each tower on its own."""
    sigma = posterior_scale({k: torch.relu(h) for k, h in hessian.items()})
    zs = [l2norm_head_apply({k: mu[k] + noise[k] * sigma[k] for k in ("w", "b")}, embed)
          for noise in draws]
    return torch.stack(zs).mean(0)
