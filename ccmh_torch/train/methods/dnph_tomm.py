"""DNPH method (TOMM'24): LinearHash heads + per-modality label predictors
(``img_pre``, ``txt_pre``) + the proxy loss - ``noise_weight`` x the
Hungarian-matched noise regularizer.  Port of
``ccmh/train/methods/dnph_tomm.py``.

The proxies are the loss-side ``extra`` tree.  The reference builds an
SGD(1e-4) over them (hash_train.py:48) and never calls its step(), so they
never move; ``ccmh`` reproduces that by default (its ``extra_tx`` is
``optax.set_to_zero()``) and so does the port: no extra optimizer, the
proxies stay at their init.  ``dnph.step_proxies=true`` steps them with
``torch.optim.SGD(proxy_lr)``.  The ±1 noise draws come from the step's
generator after the heads' dropout; the two assignments run on the host
(``losses/dnph_tomm.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dnph_tomm import (
    dnph_proxy_loss, init_dnph_proxies, noise_regularizer, random_signs,
)
from ccmh_torch.models.heads import init_linear_hash, init_pre_layer, linear_hash, pre_layer
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.train.methods.base import Method, clip_embeds, image_embeds, text_embeds


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    e = clip_cfg.embed_dim
    heads = {
        "img_head": init_linear_hash(gen, e, cfg.output_dim),
        "txt_head": init_linear_hash(gen, e, cfg.output_dim),
        "img_pre": init_pre_layer(gen, e, cfg.nclass),
        "txt_pre": init_pre_layer(gen, e, cfg.nclass),
    }
    return heads, init_dnph_proxies(gen, cfg.nclass, cfg.output_dim), {}


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    img, txt = clip_embeds(params, clip_cfg, batch, cfg)
    hi = linear_hash(params["img_head"], img.pooled, train=True, generator=generator)
    ht = linear_hash(params["txt_head"], txt.pooled, train=True, generator=generator)
    pi = pre_layer(params["img_pre"], img.pooled)
    pt = pre_layer(params["txt_pre"], txt.pooled)
    label = batch["label"]
    proxy = dnph_proxy_loss(hi, ht, pi, pt, label, label, extra["proxies"])
    noise = noise_regularizer(hi, ht, random_signs(generator, *hi.shape, hi.device))
    loss = proxy - cfg.dnph.noise_weight * noise
    return loss, (aux, {"proxy": proxy, "noise": noise})


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
    return sign_codes(linear_hash(params["img_head"], image_embeds(params, clip_cfg, images, cfg)))


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    return sign_codes(linear_hash(params["txt_head"], text_embeds(params, clip_cfg, ids, cfg)))


def _extra_optimizer(cfg: Config, extra) -> Optional[torch.optim.Optimizer]:
    if not cfg.dnph.step_proxies:
        return None      # the reference's SGD whose step() is never called
    return torch.optim.SGD([extra["proxies"]], lr=cfg.dnph.proxy_lr)


METHOD = Method(name="DNPH", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss, extra_optimizer=_extra_optimizer)
