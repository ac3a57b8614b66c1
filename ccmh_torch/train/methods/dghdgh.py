"""DGHDGH method (ICLR'26), as ``ccmh`` reconstructs it: LinearHash heads
over CLIP, the main parameters clipped to a global norm of 2.0 before
BertAdam; the GNN and the classifier are the loss-side ``extra`` tree.
Port of ``ccmh/train/methods/dghdgh.py``.

The extra optimizer (``ccmh``'s ``_extra_tx``, hash_train.py:58-60,110,129)
is one Adam(clip_lr) with two groups: the GNN, its gradients clipped to a
global norm of 1.0 first, with ``weight_decay`` added into the gradient
(torch Adam's decay, ``optax.add_decayed_weights`` before ``adam``); the
classifier, unclipped and undecayed.  Every leaf of a stepped group takes
its Adam update, a zero gradient included, as optax's do.

The J_r / J_gen running means (the reference's AverageMeters, which feed
back into the loss weights) live in ``aux`` and reset when the batch's
epoch changes.  ``dghdgh.sequenced`` replaces the fused step by the
reference's three phases (:func:`_custom_step`)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses import dghdgh as D
from ccmh_torch.models.heads import init_linear_hash, linear_hash
from ccmh_torch.ops.packing import sign_codes
from ccmh_torch.ops.similarity import l2_normalize
from ccmh_torch.train.methods.base import Method, clip_embeds, image_embeds, text_embeds
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import clip_by_global_norm_

GRAD_CLIP = 2.0    # the main parameters' global clip (hash_train.py:53-60)
GNN_CLIP = 1.0     # the GNN's (hash_train.py:108-110)


def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
    heads = {
        "img_head": init_linear_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
        "txt_head": init_linear_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
    }
    mc = cfg.dghdgh
    extra = {
        "gnn": D.init_gnn(gen, cfg.output_dim, cfg.nclass, hidden=mc.gnn_hidden,
                          n_layers=mc.n_layers, n_heads=mc.n_heads),
        "classifier": D.init_softmax_classifier(gen, cfg.output_dim, cfg.nclass),
    }
    dev = gen.device
    aux = {"j_r_avg": torch.zeros((), device=dev), "j_gen_avg": torch.zeros((), device=dev),
           "avg_count": torch.zeros((), device=dev),
           "epoch": torch.tensor(-1, dtype=torch.int32, device=dev)}
    return heads, extra, aux


def _roll_epoch(aux, batch):
    """Fresh meters at the top of every epoch (hash_train.py:69-75): reset
    them when the batch's epoch differs from the last one seen; a batch
    without an epoch keeps them."""
    if "epoch" not in batch:
        return aux
    e = torch.as_tensor(batch["epoch"], dtype=torch.int32, device=aux["epoch"].device)
    fresh = e != aux["epoch"]
    out = {k: torch.where(fresh, torch.zeros_like(aux[k]), aux[k])
           for k in ("j_r_avg", "j_gen_avg", "avg_count")}
    return {**aux, **out, "epoch": e}


def _meters(aux, j_r, j_gen):
    """The meters after this step's J_r and J_gen."""
    n = aux["avg_count"] + 1.0
    return {**aux, "j_r_avg": aux["j_r_avg"] + (j_r.detach() - aux["j_r_avg"]) / n,
            "j_gen_avg": aux["j_gen_avg"] + (j_gen.detach() - aux["j_gen_avg"]) / n,
            "avg_count": n}


def _hashes(params, batch, cfg, clip_cfg, generator):
    img, txt = clip_embeds(params, clip_cfg, batch, cfg)
    return (linear_hash(params["img_head"], img.pooled, train=True, generator=generator),
            linear_hash(params["txt_head"], txt.pooled, train=True, generator=generator))


def triplet_sampler(generator: Optional[torch.Generator]) -> D.Sampler:
    return D.gumbel_sampler(generator)


def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
    aux = _roll_epoch(aux, batch)
    hi, ht = _hashes(params, batch, cfg, clip_cfg, generator)
    loss, metrics = D.dghdgh_loss(hi, ht, batch["label"], extra["gnn"], extra["classifier"],
                                  aux["j_r_avg"], aux["j_gen_avg"], cfg.dghdgh,
                                  triplet_sampler(generator))
    return loss, (_meters(aux, metrics["J_r"], metrics["J_gen"]), metrics)


def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
    return sign_codes(linear_hash(params["img_head"], image_embeds(params, clip_cfg, images, cfg)))


def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
    return sign_codes(linear_hash(params["txt_head"], text_embeds(params, clip_cfg, ids, cfg)))


class GnnClassifierAdam(torch.optim.Adam):
    """Adam over the GNN and classifier groups; ``step(groups=...)`` steps
    only the named groups (the sequenced mode's phases), each after its
    global-norm clip, missing gradients taken as zeros."""

    def __init__(self, extra, lr: float, weight_decay: float):
        leaves = {name: [leaf for _, leaf in tree_leaves_with_path(extra[name])]
                  for name in ("gnn", "classifier")}
        super().__init__([
            {"params": leaves["gnn"], "name": "gnn", "weight_decay": weight_decay,
             "clip_norm": GNN_CLIP},
            {"params": leaves["classifier"], "name": "classifier", "weight_decay": 0.0,
             "clip_norm": 0.0},
        ], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def step(self, closure=None, groups: Optional[Sequence[str]] = None):
        for group in self.param_groups:
            active = groups is None or group["name"] in groups
            for p in group["params"]:
                if not active:
                    p.grad = None
                elif p.grad is None:
                    p.grad = torch.zeros_like(p)
            if active and group["clip_norm"] > 0:
                clip_by_global_norm_([p.grad for p in group["params"]], group["clip_norm"])
        return super().step(closure)


def _extra_optimizer(cfg: Config, extra) -> torch.optim.Optimizer:
    return GnnClassifierAdam(extra, cfg.clip_lr, cfg.weight_decay)


def _custom_step(cfg: Config, clip_cfg: ClipConfig, optimizer, extra_optimizer):
    """``dghdgh.sequenced``: the reference's per-batch sequencing
    (hash_train.py:75-130), one backward and one update each:

      phase A  J_m = λ1·J_r + λ2·J_gca + λ3·J_syn -> the model (global clip
               2.0, BertAdam) and the GNN (Adam step #1);
      phase B  λ4·J_cz on the detached embeddings -> the classifier;
      phase C  J_gen = λ5·J_ce + λ6·J_sim + λ7·J_div against the stepped GNN
               and classifier and the J_r meter including this step -> the
               GNN (Adam step #2).

    The triplets are drawn once, after the heads' dropout, and serve all
    three phases.  None (the generic fused step) unless sequenced."""
    if not cfg.dghdgh.sequenced:
        return None
    mc = cfg.dghdgh

    def step_fn(state, batch):
        label = batch["label"]
        aux = _roll_epoch(state.aux, batch)
        params, extra = state.params, state.extra
        for opt in (optimizer, extra_optimizer):
            opt.zero_grad(set_to_none=True)

        # phase A: J_m -> model + GNN
        hi, ht = _hashes(params, batch, cfg, clip_cfg, state.generator)
        sample = triplet_sampler(state.generator)
        ii_tt = D.gen_triplets(label, sample)
        it_ti = D.gen_triplets(label, sample, cross=True)
        zi, zt = l2_normalize(hi), l2_normalize(ht)
        j_r, j_gca, j_syn = D.stage2_losses(zi, zt, label, extra["gnn"], ii_tt, it_ti,
                                            aux["j_r_avg"], mc)
        lam3 = D.adaptive_lambda3(aux["j_gen_avg"], mc.beta)
        j_m = mc.lambda1 * j_r + mc.lambda2 * j_gca + lam3 * j_syn
        j_m.backward()
        clip_by_global_norm_([p.grad for g in optimizer.param_groups for p in g["params"]
                              if p.grad is not None], GRAD_CLIP)
        optimizer.step()
        extra_optimizer.step(groups=("gnn",))
        zi, zt = zi.detach(), zt.detach()
        # the J_r meter takes this step between stage 2 and stage 1
        # (hash_train.py:92)
        n = aux["avg_count"] + 1.0
        j_r_avg = aux["j_r_avg"] + (j_r.detach() - aux["j_r_avg"]) / n

        # phase B: λ4·J_cz -> the classifier
        extra_optimizer.zero_grad(set_to_none=True)
        j_cz_w = mc.lambda4 * D.classifier_ce(extra["classifier"], zi, zt, label)
        j_cz_w.backward()
        extra_optimizer.step(groups=("classifier",))

        # phase C: J_gen -> the GNN, against the stepped GNN and classifier
        extra_optimizer.zero_grad(set_to_none=True)
        j_ce, j_sim, j_div = D.stage1_losses(zi, zt, label, extra["gnn"], extra["classifier"],
                                             ii_tt, it_ti, j_r_avg, mc)
        j_gen = mc.lambda5 * j_ce + mc.lambda6 * j_sim + mc.lambda7 * j_div
        j_gen.backward()
        extra_optimizer.step(groups=("gnn",))

        j_cz = j_cz_w / mc.lambda4 if mc.lambda4 else j_cz_w
        state.aux = {**aux, "j_r_avg": j_r_avg,
                     "j_gen_avg": aux["j_gen_avg"] + (j_gen.detach() - aux["j_gen_avg"]) / n,
                     "avg_count": n}
        state.step += 1
        metrics = {"J_r": j_r, "J_gca": j_gca, "J_syn": j_syn, "J_cz": j_cz, "J_gen": j_gen,
                   "lambda3": lam3, "loss": j_m + mc.lambda4 * j_cz + j_gen}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


METHOD = Method(name="DGHDGH", init=_init, encode_image=_encode_image,
                encode_text=_encode_text, loss=_loss, extra_optimizer=_extra_optimizer,
                grad_clip=GRAD_CLIP, custom_step=_custom_step)
