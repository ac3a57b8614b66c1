"""DHaPH method (TKDE'24): LinearHash heads + the self-paced MS loss + the
hyperbolic proxy loss.  The HPmodel and the 500 LCAs are the loss-side
``extra`` tree, under their own AdamW(1e-5) (hash_train.py:47-50 builds two
AdamW optimizers with the same settings; ``ccmh`` and the port use one
over both).  Port of ``ccmh/train/methods/dhaph.py``.

``torch.optim.AdamW`` with ``eps`` added to sqrt(v̂) and the decay
``lr * wd * p`` taken from the parameter before the step is the update of
``optax.adamw``.  The triplet and Gumbel draws of the proxy loss come from
the step's generator after the heads' dropout (``losses/dhaph.py``)."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dhaph import Draws, dhaph_loss, init_hp_model, init_lcas
from ccmh_torch.train.methods.base import make_linear_hash_method
from ccmh_torch.train.optim import tree_leaves_with_path


def _init_extra(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    return {"hpmodel": init_hp_model(gen, cfg.output_dim, cfg.output_dim),
            "lcas": init_lcas(gen, cfg.dhaph, cfg.output_dim)}


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg: Config):
    epoch = batch.get("epoch")
    if epoch is None:
        epoch = torch.zeros((), dtype=torch.int32, device=hash_img.device)
    return dhaph_loss(hash_img, hash_txt, batch["label"], extra, epoch, cfg.dhaph,
                      total_epoch=cfg.epochs, draws=Draws(generator))


def _extra_optimizer(cfg: Config, extra) -> torch.optim.Optimizer:
    return torch.optim.AdamW([leaf for _, leaf in tree_leaves_with_path(extra)],
                             lr=cfg.dhaph.hp_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


METHOD = make_linear_hash_method("DHaPH", _body, init_extra=_init_extra,
                                 extra_optimizer=_extra_optimizer)
