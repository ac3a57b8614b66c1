"""DScPH loss (TMM'25): circle-proxy-filter + Householder rotation +
bit-variance quantization.

Port of ``ccmh/losses/dscph.py`` (train/DScPH/{CPF_loss.py,FAST_HPP.py}):

* CPF (CPF_loss.py:4-53): class-proxy cosine loss with exp re-weighting
  (the weights detached, as the reference's ``.detach()``), masked
  negative terms over cos > tau;
* Householder rotation: the product of K normalized-column reflections,
  applied one reflection at a time in column order as ``ccmh``'s
  ``lax.scan`` does (the reference's blocked fasthpp is another schedule
  for the same orthogonal matrix);
* bit_var_loss (FAST_HPP.py:6-11): mean sigma(z)(1 - sigma(z)).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ccmh_torch.config import DScPHConfig
from ccmh_torch.ops.similarity import l2_normalize


def init_cpf(gen: torch.Generator, embed_dim: int, n_classes: int) -> Dict:
    """xavier_uniform over [n_classes, embed_dim] (CPF_loss.py:12-13)."""
    bound = math.sqrt(6.0 / (n_classes + embed_dim))
    u = torch.rand((n_classes, embed_dim), generator=gen, device=gen.device)
    return {"weight": (2 * u - 1) * bound}


def cpf_loss(image: torch.Tensor, text: torch.Tensor, labels: torch.Tensor, cpf: Dict,
             *, tau: float = 0.9, psi: float = 0.7, sp: float = 1.3, sn: float = 1.3,
             mu: float = 1.0, b: float = 2.0) -> torch.Tensor:
    w = l2_normalize(cpf["weight"])

    def one_modality(feat):
        cos = l2_normalize(feat) @ w.T                         # [B, C]
        # torch.maximum against a tensor splits a tie's gradient as jnp does
        tp = (torch.maximum(cos, torch.zeros_like(cos)) * labels).sum() * 2.0 + b
        wp = torch.exp((1.0 - cos) * sp).detach()
        lossp = ((1.0 - cos) * wp * labels).sum()
        wn = torch.exp((cos - mu) * sn).detach()
        lossn = torch.where(cos > tau, (cos - psi) * wn * (1.0 - labels),
                            torch.zeros_like(cos)).sum()
        return 1.0 - tp / (tp + lossp + lossn)

    return one_modality(image) + one_modality(text)


def init_householder(dim: int, device=None) -> Dict:
    return {"weights": torch.eye(dim, device=device)}


def householder_rotate(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Apply the product of Householder reflections H_0..H_{d-1} (columns of
    the normalized weight matrix) to x: [B, d] -> [B, d]."""
    v = l2_normalize(p["weights"], dim=0)
    for vi in v.T:
        # H x = x - 2 v (v^T x)
        x = x - 2.0 * (x @ vi)[:, None] * vi[None, :]
    return x


def bit_var_loss(z: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(z)
    return (s * (1.0 - s)).mean()


def dscph_loss(hash_img: torch.Tensor, hash_txt: torch.Tensor, label: torch.Tensor,
               heads: Dict, mcfg: DScPHConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hash_train.py:63-70: CPF + bit-variance of rotated, row-normalized codes."""
    cpf = cpf_loss(hash_img, hash_txt, label, heads["cpf"], tau=mcfg.tau)
    img_rot = l2_normalize(householder_rotate(heads["rot"], hash_img))
    txt_rot = l2_normalize(householder_rotate(heads["rot"], hash_txt))
    quant = bit_var_loss(img_rot) + bit_var_loss(txt_rot)
    return cpf + quant, {"cpf": cpf, "bit_var": quant}
