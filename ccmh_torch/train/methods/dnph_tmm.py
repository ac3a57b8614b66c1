"""DNpH method (TMM'24): LinearHash heads + QSMI loss
(train/DNpH_TMM/hash_train.py:61-70).  Port of
``ccmh/train/methods/dnph_tmm.py``."""

from ccmh_torch.losses.dnph_tmm import qmi_loss
from ccmh_torch.train.methods.base import make_linear_hash_method


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg):
    return qmi_loss(hash_img, hash_txt, batch["label"])


METHOD = make_linear_hash_method("DNpH", _body)
