"""DScPH method (TMM'25): LinearHash + CPF proxies + Householder rotation.
Both live in the head tree (``loss_heads``) under BertAdam at the head lr,
as in ``ccmh``, which trains the rotation by default (the reference never
optimizes it: hash_train.py:37-44 leaves ``self.rot`` out of every group).
``dscph.train_rot=False`` detaches the rotation, reproducing the
reference's frozen rotation.  Port of ``ccmh/train/methods/dscph.py``."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dscph import dscph_loss, init_cpf, init_householder
from ccmh_torch.train.methods.base import make_linear_hash_method


def _init_heads(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    return {"loss_heads": {"cpf": init_cpf(gen, cfg.output_dim, cfg.nclass),
                           "rot": init_householder(cfg.output_dim, device=gen.device)}}


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg: Config):
    heads = params["loss_heads"]
    if not cfg.dscph.train_rot:
        heads = {**heads, "rot": {k: v.detach() for k, v in heads["rot"].items()}}
    return dscph_loss(hash_img, hash_txt, batch["label"], heads, cfg.dscph)


METHOD = make_linear_hash_method("DScPH", _body, init_heads=_init_heads)
