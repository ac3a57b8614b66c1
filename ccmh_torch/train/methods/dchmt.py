"""DCHMT method (MM'22): select-mechanism hash heads (model/DCHMT.py:8-45)
over the shared CLIP, our_loss, argmax-pair code extraction
(train/base.py:150-178).  Port of ``ccmh/train/methods/dchmt.py``."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dchmt import dchmt_loss
from ccmh_torch.models.heads import (
    init_linear_hash, init_select_hash, linear_hash, select_code, select_hash,
)
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.train.methods.base import Method, clip_embeds, image_embeds, text_embeds


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    init = init_select_hash if cfg.dchmt.hash_layer == "select" else init_linear_hash
    heads = {
        "img_head": init(gen, clip_cfg.embed_dim, cfg.output_dim),
        "txt_head": init(gen, clip_cfg.embed_dim, cfg.output_dim),
    }
    return heads, None, {}


def _codes(head, embeds: torch.Tensor, cfg: Config) -> torch.Tensor:
    if cfg.dchmt.hash_layer == "select":
        return select_code(select_hash(head, embeds))
    return sign_codes(linear_hash(head, embeds))


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
    return _codes(params["img_head"], image_embeds(params, clip_cfg, images, cfg), cfg)


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    return _codes(params["txt_head"], text_embeds(params, clip_cfg, ids, cfg), cfg)


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    img, txt = (out.pooled for out in clip_embeds(params, clip_cfg, batch, cfg))
    if cfg.dchmt.hash_layer == "select":
        # [B, K, 2] pairs -> [B, 2K] (hash_train.py:55-57)
        hi = select_hash(params["img_head"], img).flatten(1)
        ht = select_hash(params["txt_head"], txt).flatten(1)
    else:
        hi = linear_hash(params["img_head"], img, train=True, generator=generator)
        ht = linear_hash(params["txt_head"], txt, train=True, generator=generator)
    loss, metrics = dchmt_loss(hi, ht, batch["label"], cfg.dchmt, cfg.output_dim)
    return loss, (aux, metrics)


METHOD = Method(name="DCHMT", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss)
