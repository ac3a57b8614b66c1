"""MITH method (MM'23): token-level interaction hashing.  Port of
``ccmh/train/methods/mith.py``.

The towers run in the ``mith`` mode (every token projected, the text
tower under the key-padding mask); the hashing model's concept-learning
weights are shared by both modalities; four epoch-persistent buffers of
every train item's codes live in ``aux`` with the labels of the whole
train split (train/MITH/hash_train.py:44-49), which the Trainer fills.
A code is ``sign(tokens_hash + cls_hash)`` (train/base.py:180-203,
get_code_MITH), computed per tower from the hashing model's halves.
"""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.mith import mith_loss
from ccmh_torch.models.mith import (
    MithOutputs, hashing_model, image_hash, init_hashing_model, text_hash,
)
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.ops.similarity import calc_neighbor
from ccmh_torch.train.methods.base import Method, clip_embeds, image_features, text_features

BUFFERS = ("img_tokens", "img_cls", "txt_tokens", "txt_cls")


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    heads = {"hash": init_hashing_model(gen, clip_cfg.embed_dim, cfg.output_dim, cfg.mith)}
    n, dev = cfg.train_num, gen.device
    aux = {
        "buffers": {name: torch.randn((n, cfg.output_dim), generator=gen, device=dev)
                    for name in BUFFERS},
        "train_labels": torch.zeros((n, cfg.nclass), device=dev),   # filled by the Trainer
    }
    return heads, None, aux


def _forward(params, batch, cfg: Config, clip_cfg: ClipConfig) -> MithOutputs:
    img, txt = clip_embeds(params, clip_cfg, batch, cfg, features=METHOD.features)
    return hashing_model(params["hash"],
                         img.tokens_proj[:, 1:, :],    # patch tokens (cls excluded)
                         txt.tokens_proj,
                         img.pooled,                   # projected cls token
                         txt.pooled,                   # EOS token
                         txt.key_padding_mask,
                         top_k=cfg.mith.top_k_label)


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    out = _forward(params, batch, cfg, clip_cfg)
    label_sim = calc_neighbor(aux["train_labels"], batch["label"])
    # the buffers take the batch's detached codes at its rows BEFORE the
    # loss (train/MITH/hash_train.py:72-83): the Bayesian terms see them
    idx = batch["index"].long()
    codes = {"img_tokens": out.img_tokens_hash, "img_cls": out.img_cls_hash,
             "txt_tokens": out.txt_tokens_hash, "txt_cls": out.txt_cls_hash}
    buffers = {name: aux["buffers"][name].index_copy(0, idx, codes[name].detach())
               for name in BUFFERS}
    loss, metrics = mith_loss(out, label_sim, buffers, cfg.mith, cfg.output_dim)
    return loss, ({**aux, "buffers": buffers}, metrics)


def _image_bits(params, images, cfg: Config, clip_cfg: ClipConfig) -> torch.Tensor:
    """The image code before its sign: tokens_hash + cls_hash."""
    img = image_features(params, clip_cfg, images, cfg, features=METHOD.features)
    ic, _, it, _ = image_hash(params["hash"], img.tokens_proj[:, 1:, :], img.pooled,
                              top_k=cfg.mith.top_k_label)
    return it + ic


def _text_bits(params, ids, cfg: Config, clip_cfg: ClipConfig) -> torch.Tensor:
    """The text code before its sign, under the key-padding mask ids == 0."""
    txt = text_features(params, clip_cfg, ids, cfg, features=METHOD.features,
                        key_padding_mask=ids == 0)
    tc, _, tt, _ = text_hash(params["hash"], txt.tokens_proj, txt.pooled,
                             txt.key_padding_mask, top_k=cfg.mith.top_k_label)
    return tt + tc


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
    return sign_codes(_image_bits(params, images, cfg, clip_cfg))


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    return sign_codes(_text_bits(params, ids, cfg, clip_cfg))


METHOD = Method(name="MITH", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss, features="mith", needs_mask=True)
