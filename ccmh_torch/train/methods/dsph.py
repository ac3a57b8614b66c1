"""DSPH method (TCSVT'23): LinearHash heads + HyP proxy loss, the proxies
under their own SGD (train/DSPH/hash_train.py:25-46).  Port of
``ccmh/train/methods/dsph.py``.

``ccmh`` steps the proxies with ``add_decayed_weights -> trace -> scale(-lr)``;
``torch.optim.SGD`` with ``weight_decay``, ``momentum``, ``dampening=0`` and
``nesterov=False`` is the same update (the decay added to the gradient
before the momentum trace, the first trace the gradient itself)."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dsph import codetable_threshold, hyp_loss, init_proxies
from ccmh_torch.train.methods.base import make_linear_hash_method


def _init_extra(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    # ccmh folds hypseed into the proxies' key: they depend on both seeds
    seed = (gen.initial_seed() * 1_000_003 + cfg.dsph.hypseed) % 2 ** 63
    proxy_gen = torch.Generator(device=gen.device).manual_seed(seed)
    return {"proxies": init_proxies(proxy_gen, cfg.nclass, cfg.output_dim)}


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg: Config):
    threshold = codetable_threshold(cfg.output_dim, cfg.nclass)
    return hyp_loss(hash_img, hash_txt, batch["label"], extra["proxies"], threshold,
                    cfg.dsph.alpha)


def _extra_optimizer(cfg: Config, extra) -> torch.optim.Optimizer:
    """SGD(lr=0.02, momentum=0.9, wd=5e-4) for the proxies
    (train/DSPH/hash_train.py:44)."""
    return torch.optim.SGD([extra["proxies"]], lr=cfg.dsph.proxy_lr,
                           momentum=cfg.dsph.proxy_momentum,
                           weight_decay=cfg.dsph.proxy_weight_decay,
                           dampening=0, nesterov=False)


METHOD = make_linear_hash_method("DSPH", _body, init_extra=_init_extra,
                                 extra_optimizer=_extra_optimizer)
