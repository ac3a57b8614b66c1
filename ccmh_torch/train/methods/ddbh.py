"""DDBH method (TCSVT'25): LinearHash heads + boundary-point loss (the
repaired method of ``ccmh``; the reference model/trainer pair is
unrunnable as committed).  Port of ``ccmh/train/methods/ddbh.py``."""

from ccmh_torch.losses.ddbh import ddbh_loss
from ccmh_torch.train.methods.base import make_linear_hash_method


def _body(hash_img, hash_txt, batch, params, extra, aux, generator, cfg):
    return ddbh_loss(hash_img, hash_txt, batch["label"], cfg.ddbh, cfg.output_dim)


METHOD = make_linear_hash_method("DDBH", _body)
