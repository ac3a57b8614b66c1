"""MITH's five-part loss (MM'23).

Port of ``ccmh/losses/mith.py`` (train/MITH/hash_train.py:104-200):

* the Bayesian likelihood against epoch-persistent buffers of every train
  code (tokens intra, cls inter); the buffers live in the method's ``aux``
  and are written at the batch's rows before the loss (:72-78);
* the quantization toward the λ-blended joint sign target (:80-83,146-147);
* a global InfoNCE and a token-level batched InfoNCE (:103-136);
* bidirectional distillation cls <-> tokens, 1x student / 0.1x teacher
  (:192-200).

Each ``jax.lax.stop_gradient`` of ``ccmh`` is a ``.detach()`` here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ccmh_torch.config import MITHConfig
from ccmh_torch.models.mith import MithOutputs


def bayesian_loss(a: torch.Tensor, b: torch.Tensor, label_sim: torch.Tensor) -> torch.Tensor:
    s = torch.clamp(0.5 * a @ b.T, -64.0, 64.0)
    return -(label_sim * s - F.softplus(s)).mean()


def info_nce_loss(out_1: torch.Tensor, out_2: torch.Tensor, temperature: float) -> torch.Tensor:
    scores = out_1 @ out_2.T / temperature
    targets = torch.arange(out_1.shape[0], device=out_1.device)
    return 0.5 * (F.cross_entropy(scores, targets) + F.cross_entropy(scores.T, targets))


def info_nce_loss_bmm(out_1: torch.Tensor, out_2: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """Token-level InfoNCE over [B, L, D] pairs (hash_train.py:118-136)."""
    sim = torch.einsum("bld,bmd->blm", out_1, out_2) / temperature
    B, L = sim.shape[:2]
    targets = torch.arange(L, device=sim.device).repeat(B)
    return 0.5 * (F.cross_entropy(sim.reshape(B * L, L), targets)
                  + F.cross_entropy(sim.transpose(1, 2).reshape(B * L, L), targets))


def quantization_loss(hash_feature: torch.Tensor, B: torch.Tensor, k_bits: int) -> torch.Tensor:
    return ((hash_feature - B) ** 2).sum() / hash_feature.shape[0] / k_bits


def mith_loss(out: MithOutputs, label_sim: torch.Tensor, buffers: Dict[str, torch.Tensor],
              mcfg: MITHConfig, k_bits: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """label_sim [train_num, B]; buffers: img/txt tokens/cls [train_num, K]."""
    lam = mcfg.hyper_lambda
    B_target = torch.sign((out.img_cls_hash * lam + out.img_tokens_hash * (1 - lam)
                           + out.txt_cls_hash * lam + out.txt_tokens_hash * (1 - lam)).detach())

    losses = {}
    losses["tokens_intra_likelihood"] = mcfg.hyper_tokens_intra * (
        bayesian_loss(buffers["img_tokens"], out.img_tokens_hash, label_sim)
        + bayesian_loss(buffers["txt_tokens"], out.txt_tokens_hash, label_sim))
    losses["cls_inter_likelihood"] = mcfg.hyper_cls_inter * (
        bayesian_loss(buffers["img_cls"], out.txt_cls_hash, label_sim)
        + bayesian_loss(buffers["txt_cls"], out.img_cls_hash, label_sim))

    H_i = out.img_cls_hash * 0.5 + out.img_tokens_hash * 0.5
    H_t = out.txt_cls_hash * 0.5 + out.txt_tokens_hash * 0.5
    losses["quantization"] = mcfg.hyper_quan * (
        quantization_loss(H_i, B_target, k_bits) + quantization_loss(H_t, B_target, k_bits))

    losses["infoNCE"] = mcfg.hyper_info_nce * (
        info_nce_loss(out.res_img_cls, out.res_txt_cls, mcfg.nce_temperature)
        + mcfg.hyper_alpha * info_nce_loss_bmm(out.trans_tokens_i, out.trans_tokens_t,
                                               mcfg.nce_temperature))

    item_1 = (((out.img_cls_hash.detach() - out.img_tokens_hash) ** 2).sum()
              + ((out.txt_cls_hash.detach() - out.txt_tokens_hash) ** 2).sum())
    item_2 = 0.1 * (((out.img_cls_hash - out.img_tokens_hash.detach()) ** 2).sum()
                    + ((out.txt_cls_hash - out.txt_tokens_hash.detach()) ** 2).sum())
    losses["distillation"] = mcfg.hyper_distill * (item_1 + item_2) / out.img_cls_hash.shape[0]
    return sum(losses.values()), losses
