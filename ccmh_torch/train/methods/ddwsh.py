"""DDWSH method (TMM'26): LinearHash heads + margin loss with
distance-weighted mining; the per-class beta lives in the head tree under
BertAdam at the head lr (hash_train.py:41-48 puts criterion.parameters()
in the BertAdam groups).  The draws of the miner come from the step's
generator after the heads' dropout (Gumbel-max, losses/ddwsh.py).  Port of
``ccmh/train/methods/ddwsh.py``."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.ddwsh import ddwsh_loss, gumbel_max, init_ddwsh_extra
from ccmh_torch.train.methods.base import make_linear_hash_method


def _init_heads(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    return {"loss_heads": init_ddwsh_extra(cfg.nclass, cfg.ddwsh.beta_init, device=gen.device)}


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg: Config):
    return ddwsh_loss(hash_img, hash_txt, batch["label"], params["loss_heads"], cfg.ddwsh,
                      lambda logits: gumbel_max(logits, generator))


METHOD = make_linear_hash_method("DDWSH", _body, init_heads=_init_heads)
