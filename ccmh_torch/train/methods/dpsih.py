"""DPSIH method (AAAI'26): LinearHash heads + DSIE multi-embed codes + the
MSC loss.  Port of ``ccmh/train/methods/dpsih.py``.

The towers run in the ``tokens`` mode (image tokens at the vision width,
text tokens at the transformer width).  Codes are [B, E, K] multi-embeds,
flattened to [B, E*K]; evaluation and serving rank them by the best embed
pair (train/DPSIH/_utils.py:5-31), the method's ``dist_fn``, so the packed
Hamming kernel is not used for DPSIH.  The main parameters' gradients are
clipped by their global norm at 2.0 before BertAdam
(train/DPSIH/hash_train.py:70-71).
"""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dpsih import dpsih_loss
from ccmh_torch.models.dpsih import dsie, init_dsie, l2norm
from ccmh_torch.models.heads import init_linear_hash, linear_hash
from ccmh_torch.ops.hamming import hamming_distance
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.train.methods.base import Method, clip_embeds, image_features, text_features

NUM_EMBEDS = 4  # train/DPSIH/get_args.py:16


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    d_img, d_txt = clip_cfg.vision_width, clip_cfg.transformer_width
    heads = {
        "img_head": init_linear_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
        "txt_head": init_linear_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
        "dsie_i": init_dsie(gen, NUM_EMBEDS, d_img, cfg.output_dim, d_img // 2),
        "dsie_t": init_dsie(gen, NUM_EMBEDS, d_txt, cfg.output_dim, d_txt // 2),
    }
    return heads, None, {}


def _embeds(params, out, head: str, generator=None, train=False):
    """A tower's ``tokens`` output -> (l2-normalized [B, E, K] embeds, residual)."""
    h = linear_hash(params[f"{head}_head"], out.pooled, train=train, generator=generator)
    embed, _, residual = dsie(params[f"dsie_{head[0]}"], h, out.tokens_pre)
    return l2norm(embed), residual


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    img, txt = clip_embeds(params, clip_cfg, batch, cfg, features=METHOD.features)
    ei, ri = _embeds(params, img, "img", generator, train=True)
    et, rt = _embeds(params, txt, "txt", generator, train=True)
    loss, metrics = dpsih_loss(ei, et, ri, rt, batch["label"], cfg.dpsih,
                               num_embeds=NUM_EMBEDS)
    return loss, (aux, metrics)


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
    """±1 multi-embed codes flattened to [B, E*K] (``dist_fn`` splits them)."""
    out = image_features(params, clip_cfg, images, cfg, features=METHOD.features)
    return sign_codes(_embeds(params, out, "img")[0]).flatten(1)


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    out = text_features(params, clip_cfg, ids, cfg, features=METHOD.features)
    return sign_codes(_embeds(params, out, "txt")[0]).flatten(1)


def make_dist_fn(output_dim: int):
    """Pseudo-Hamming distance of the best embed pair
    (train/DPSIH/_utils.py:16-26): d = (K - max_{e,f} q_e . r_f) / 2, i.e.
    the least Hamming distance over the E x E pairs, one [Q, N] product per
    pair (``ccmh`` writes it as one [Q, N, E, E] einsum; the integers are
    the same)."""

    def dist(q_flat: torch.Tensor, r_flat: torch.Tensor) -> torch.Tensor:
        qc = q_flat.reshape(q_flat.shape[0], -1, output_dim)
        rc = r_flat.reshape(r_flat.shape[0], -1, output_dim)
        best = None
        for e in range(qc.shape[1]):
            for f in range(rc.shape[1]):
                d = hamming_distance(qc[:, e], rc[:, f])
                best = d if best is None else torch.minimum(best, d)
        return best

    return dist


def _dist_fn(cfg: Config):
    return make_dist_fn(cfg.output_dim)


METHOD = Method(name="DPSIH", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss, dist_fn=_dist_fn,
                features="tokens", grad_clip=2.0)
