"""DPBE method (MM'25): Bayesian Linear->L2Norm heads with a diagonal
Laplace posterior; the Hessian EMA lives in ``aux``.  Port of
``ccmh/train/methods/dpbe.py``.

The loss updates the EMA with no gradient, ``f * old + relu(new)``.  Its
weight noise comes from the step's generator (``losses/dpbe.py``).
Encoding is deterministic, as ``ccmh``'s (``PRNGKey(cfg.seed)`` on every
call): each encode call draws the noise of both heads from a fresh
generator seeded with ``cfg.seed``, sample by sample, image head then text
head, so the image noise depends neither on whether the text side is
encoded nor on the batch size, and a served query and a served gallery
item see the same weights."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dpbe import dpbe_encode_codes, dpbe_sampled_loss, normal_draw
from ccmh_torch.models.heads import init_l2norm_hash
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.train.methods.base import Method, clip_embeds, image_embeds, text_embeds


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    heads = {
        "img_head": init_l2norm_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
        "txt_head": init_l2norm_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
    }
    # hessian init: data_size * ones (stochman/laplace.py:63-66)
    aux = {name: {k: torch.full_like(v, float(cfg.train_num)) for k, v in heads[head].items()}
           for name, head in (("hessian_i", "img_head"), ("hessian_t", "txt_head"))}
    return heads, None, aux


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    img, txt = clip_embeds(params, clip_cfg, batch, cfg)
    mcfg = cfg.dpbe
    loss, h_i, h_t = dpbe_sampled_loss(
        img.pooled, txt.pooled, batch["label"], params["img_head"], params["txt_head"],
        aux["hessian_i"], aux["hessian_t"], normal_draw(generator, img.pooled.device),
        n_samples=mcfg.n_samples, max_pairs=mcfg.max_pairs, train_num=cfg.train_num)
    f = mcfg.hessian_ema
    with torch.no_grad():
        new_aux = {name: {k: f * aux[name][k] + torch.relu(new[k]) for k in new}
                   for name, new in (("hessian_i", h_i), ("hessian_t", h_t))}
    return loss, ({**aux, **new_aux}, {})


def encode_draws(cfg: Config, params, device) -> Tuple[List, List]:
    """The eval noise of both heads, from a fresh generator seeded with
    ``cfg.seed``: per sample the image head's w and b, then the text
    head's."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    draws = ([], [])
    for _ in range(cfg.dpbe.n_samples):
        for out, head in zip(draws, ("img_head", "txt_head")):
            out.append({k: torch.randn(tuple(params[head][k].shape), generator=gen,
                                       device=device) for k in ("w", "b")})
    return draws


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
    embed = image_embeds(params, clip_cfg, images, cfg)
    draws = encode_draws(cfg, params, embed.device)[0]
    return sign_codes(dpbe_encode_codes(embed, params["img_head"], aux["hessian_i"], draws))


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    embed = text_embeds(params, clip_cfg, ids, cfg)
    draws = encode_draws(cfg, params, embed.device)[1]
    return sign_codes(dpbe_encode_codes(embed, params["txt_head"], aux["hessian_t"], draws))


METHOD = Method(name="DPBE", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss)
