"""DMsH_LN method (Neurocomputing'24): LinearHash heads + LabelNet +
multi-similarity loss.  The label net lives in the head tree and trains
under the same BertAdam at the head lr (train/DMsH_LN/hash_train.py:36-46
puts L_net in the optimizer groups).  Port of
``ccmh/train/methods/dmsh_ln.py``."""

from __future__ import annotations

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dmsh_ln import dmsh_ln_loss, init_label_net
from ccmh_torch.train.methods.base import make_linear_hash_method


def _init_heads(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    return {"label_net": init_label_net(gen, cfg.nclass, cfg.output_dim)}


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg: Config):
    # the Trainer puts the epoch into every train batch (labelnet.py's
    # annealed sharpness); a bare batch counts as epoch 0
    epoch = batch.get("epoch")
    if epoch is None:
        epoch = torch.zeros((), dtype=torch.int32, device=hash_img.device)
    return dmsh_ln_loss(hash_img, hash_txt, batch["label"], params["label_net"], epoch,
                        cfg.dmsh_ln)


METHOD = make_linear_hash_method("DMsH_LN", _body, init_heads=_init_heads)
