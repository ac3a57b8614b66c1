"""TwDH losses (TOMM'24): hash-centre BCE + soft-argmax quantization.  Port
of ``ccmh/losses/twdh.py`` (train/TwDH/hash_train.py:93-163):

* per-sample hash-centre targets: the sign of the mean of the sample's
  class centres, zeros broken by one random ±1 vector shared across the
  batch (hash_center_multilables, :103-122);
* the ±1 centre as a one-hot softmax-pair target [B, 2K] (hash_convert,
  :84-101);
* BCE between the softmax-pair code and the pair target;
* soft_argmax_hash_loss (:124-129): 1 - mean((2c - 1)^2).

The centre and transform assets are the port's own copy of ``ccmh``'s
(``ccmh_torch/assets/twdh/<dataset>.npz``).  The random ±1 vectors come
from the step's generator through :func:`random_center`, the long code's
first, then each short length's in ascending order.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "assets", "twdh")


def load_twdh_assets(dataset: str, long_dim: int, path: str = "", device=None) -> Dict:
    """-> {"long_center": [C, K], "short_center": {k: [C, k]}, "trans":
    {k: [2K, 2k]}} for the long code length ``long_dim``, int keys."""
    name = {"flickr": "mirflickr", "mirflickr": "mirflickr"}.get(dataset, dataset)
    npz_path = path or os.path.join(_ASSET_DIR, f"{name}.npz")

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    with np.load(npz_path, allow_pickle=False) as data:
        out = {"long_center": t(data[f"long/{long_dim}"]), "short_center": {}, "trans": {}}
        for key in data.files:
            parts = key.split("/")
            if parts[0] == "trans" and int(parts[1]) == long_dim:
                out["trans"][int(parts[2])] = t(data[key])
            elif parts[0] == "short":
                out["short_center"][int(parts[1])] = t(data[key])
    return out


def int_keys(d: Dict) -> Dict[int, torch.Tensor]:
    """A code-length dict with int keys, in ascending order: after an
    ``.npz`` round trip the keys come back as strings, and "8" sorts after
    "16"."""
    return {int(k): d[k] for k in sorted(d, key=int)}


def random_center(generator: Optional[torch.Generator], k: int, device) -> torch.Tensor:
    """[K] uniform ±1 floats (``2 * randint(0, 2) - 1``)."""
    return 2.0 * torch.randint(0, 2, (k,), generator=generator, device=device).float() - 1.0


def hash_center_targets(center_signs: torch.Tensor, labels: torch.Tensor,
                        centers: torch.Tensor) -> torch.Tensor:
    """[B, C] labels + [C, K] ±1 centres -> [B, 2K] one-hot pair targets;
    ``center_signs`` [K] breaks the zeros."""
    mean = (labels @ centers) / torch.clamp(labels.sum(1, keepdim=True), min=1.0)
    sign = torch.sign(mean)                                    # -1 / 0 / +1
    center = torch.where(sign == 0, center_signs[None, :], sign)
    bit = (center > 0).long()                                  # 0 -> (1,0), 1 -> (0,1)
    return torch.nn.functional.one_hot(bit, 2).float().reshape(labels.shape[0], -1)


# the smallest normal float32, the floor inside the log: torch.nn.BCELoss
# clamps the log terms at -100, log(min normal) = -87.3
_MIN_NORMAL = 1.1754944e-38


def bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """BCELoss with bounded log terms.  An eps-clip of ``p`` does not work
    in float32 (1 - 1e-12 rounds to 1.0, and a saturated pair gives 0 *
    log(0) = NaN), and ``maximum(log(p), -100)`` still gives NaN in the
    backward; flooring p inside the log keeps both finite."""
    floor = torch.tensor(_MIN_NORMAL, dtype=p.dtype, device=p.device)
    log_p = torch.log(torch.maximum(p, floor))
    log_1p = torch.log(torch.maximum(1.0 - p, floor))
    return -(t * log_p + (1.0 - t) * log_1p).mean()


def soft_argmax_hash_loss(code_flat: torch.Tensor) -> torch.Tensor:
    return 1.0 - ((2.0 * code_flat - 1.0) ** 2).mean()


def twdh_loss(img_long: torch.Tensor, txt_long: torch.Tensor,
              img_short: Dict[int, torch.Tensor], txt_short: Dict[int, torch.Tensor],
              labels: torch.Tensor, assets: Dict, generator: Optional[torch.Generator],
              quan_alpha: float = 0.5, low_rate: float = 0.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    dev = img_long.device
    long_center = assets["long_center"]
    long_target = hash_center_targets(random_center(generator, long_center.shape[1], dev),
                                      labels, long_center)
    long_nce = (bce(img_long, long_target) + bce(txt_long, long_target)) / 2.0
    long_quan = (soft_argmax_hash_loss(img_long) + soft_argmax_hash_loss(txt_long)) / 2.0
    loss = long_nce + quan_alpha * long_quan
    metrics = {"long_nce": long_nce, "long_quan": long_quan}
    for k, center in int_keys(assets["short_center"]).items():
        target = hash_center_targets(random_center(generator, center.shape[1], dev),
                                     labels, center)
        s_nce = (bce(img_short[k], target) + bce(txt_short[k], target)) / 2.0
        s_quan = (soft_argmax_hash_loss(img_short[k]) + soft_argmax_hash_loss(txt_short[k])) / 2.0
        loss = loss + low_rate * (s_nce + s_quan)
        metrics[f"short{k}_nce"] = s_nce
    return loss, metrics
