"""TwDH method (TOMM'24): two-step discrete hashing with a long code and
short codes derived from it (model/TwDH.py:93-171, train/TwDH/hash_train.py).
Port of ``ccmh/train/methods/twdh.py``.

The heads are ModalityHash modules (one-token attention, a norm, 2K
softmax pairs): BatchNorm on the image side, with its running stats in
``aux["bn"]``, LayerNorm on the text side.  The short codes are
``softmax_pair_quantize(long @ trans[k])`` with the per-dataset transform
matrices, which live in ``aux["assets"]`` (read from ``twdh.center_path``
or the port's copy of the shipped assets).  Their code-length keys are
read as ``int`` wherever they come from: after an ``.npz`` round trip they
are strings, and the loss folds the i-th short length by ascending order.

Reference quirk, reproduced as in ``ccmh``: TwDH's valid() never switches
the model to eval mode (hash_train.py:206-217), so every encode runs the
image BatchNorm in train mode, with the eval batch's statistics; the
Trainer hands over the batch's ``valid`` rows so that wrap-padded rows do
not count.  The running stats are updated in training and read by nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.twdh import int_keys, load_twdh_assets, twdh_loss
from ccmh_torch.models.heads import (
    init_bn_state, init_modality_hash, modality_hash, pair_code, softmax_pair_quantize,
)
from ccmh_torch.train.methods.base import Method, clip_embeds, image_embeds, text_embeds


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    e = clip_cfg.embed_dim
    heads = {
        "img_head": init_modality_hash(gen, e, cfg.output_dim, layernorm=False),
        "txt_head": init_modality_hash(gen, e, cfg.output_dim, layernorm=True),
    }
    aux = {"bn": init_bn_state(e, device=gen.device)}
    if not cfg.pretrained:
        # a --pretrained checkpoint's aux, assets included, replaces the
        # init's, so serving and restored runs need no asset file
        aux["assets"] = load_twdh_assets(cfg.dataset, cfg.output_dim, cfg.twdh.center_path,
                                         device=gen.device)
    return heads, None, aux


def _image_long(params, aux, embed, *, mask=None):
    """The image long code with train-mode BatchNorm, and the new BN state."""
    return modality_hash(params["img_head"], embed, train=True, bn_state=aux["bn"], mask=mask)


def _text_long(params, embed):
    return modality_hash(params["txt_head"], embed)[0]


def _short(long_code, assets) -> Dict[int, torch.Tensor]:
    return {k: softmax_pair_quantize(long_code @ t) for k, t in int_keys(assets["trans"]).items()}


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    img, txt = clip_embeds(params, clip_cfg, batch, cfg)
    img_long, new_bn = _image_long(params, aux, img.pooled)
    txt_long = _text_long(params, txt.pooled)
    assets = aux["assets"]
    loss, metrics = twdh_loss(img_long, txt_long, _short(img_long, assets),
                              _short(txt_long, assets), batch["label"], assets, generator,
                              quan_alpha=0.5, low_rate=cfg.twdh.low_rate)
    return loss, ({**aux, "bn": {k: v.detach() for k, v in new_bn.items()}}, metrics)


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig,
                  valid: Optional[torch.Tensor] = None):
    """Image codes with the BatchNorm statistics of this batch (of its
    ``valid`` rows where given): a served chunk's codes follow the chunk,
    as ``ccmh``'s Retriever's do."""
    embed = image_embeds(params, clip_cfg, images, cfg)
    return pair_code(_image_long(params, aux, embed, mask=valid)[0])


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    return pair_code(_text_long(params, text_embeds(params, clip_cfg, ids, cfg)))


def _multi_encode(params, aux, batch, cfg: Config, clip_cfg: ClipConfig):
    """The long code and every short length's (hash_train.py:179-217)."""
    img_long = _image_long(params, aux, image_embeds(params, clip_cfg, batch["image"], cfg),
                           mask=batch.get("valid"))[0]
    txt_long = _text_long(params, text_embeds(params, clip_cfg, batch["text"], cfg))
    out = {"long": (pair_code(img_long), pair_code(txt_long))}
    img_short, txt_short = _short(img_long, aux["assets"]), _short(txt_long, aux["assets"])
    for k in img_short:
        out[f"short{k}"] = (pair_code(img_short[k]), pair_code(txt_short[k]))
    return out


METHOD = Method(name="TwDH", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss, multi_encode=_multi_encode,
                encode_takes_valid=True)
