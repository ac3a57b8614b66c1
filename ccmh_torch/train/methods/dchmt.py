"""DCHMT method (MM'22), encode side: select-mechanism hash heads
(model/DCHMT.py:8-45) over the shared CLIP, argmax-pair code extraction
(train/base.py:150-178).  Port of ``ccmh/train/methods/dchmt.py``; the
loss comes with the training slice."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.models.heads import (
    init_linear_hash, init_select_hash, linear_hash, select_code, select_hash,
)
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.train.methods.base import Method, image_embeds, text_embeds


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


METHOD = Method(name="DCHMT", init=_init, encode_image=_encode_image,
                encode_text=_encode_text)
