"""Training state and the train step (port of ``ccmh/train/state.py``).

``ccmh`` threads a functional TrainState through one jitted XLA program per
step.  PyTorch runs eagerly: the state holds the parameter tree (leaf
tensors with ``requires_grad``), the method's ``extra`` and ``aux`` trees,
the step counter and the ``torch.Generator`` of the step's randomness, and
the step is forward, loss, backward, the method's global gradient clip
where it has one (DPSIH's), and one BertAdam step, updating the parameters
in place.  A method's loss-side ``extra`` parameters (DSPH's proxies)
take the same backward and their own optimizer (``ccmh``'s ``extra_tx``),
stepped after BertAdam.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ccmh_torch.config import Config
from ccmh_torch.train.optim import BertAdam, bert_adam_for, tree_leaves_with_path

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    params: Params                  # {"clip": ..., "img_head": ..., "txt_head": ...}
    extra: Optional[Params]         # loss-side trainables (DSPH's proxies)
    aux: Params                     # non-trainable method state
    step: int
    generator: torch.Generator      # the steps' randomness (dropout)


def make_main_optimizer(cfg: Config, params: Params, steps_per_epoch: int) -> BertAdam:
    """BertAdam over clip + heads with the reference param groups: clip at
    ``clip_lr``, the rest at ``lr``; warmup_cosine over
    ``t_total = steps_per_epoch * epochs``; per-layer clipping of the
    stacked transformer blocks; ``cfg.optim_moments_dtype`` other than
    float32 stores the moments in that type (``ccmh``'s opt-in)."""
    return bert_adam_for(
        params, cfg.lr, {"clip": cfg.clip_lr},
        warmup=cfg.warmup_proportion,
        t_total=max(steps_per_epoch * cfg.epochs, 1),
        schedule="warmup_cosine",
        b1=0.9, b2=0.98, eps=1e-6,
        weight_decay=cfg.weight_decay,
        max_grad_norm=1.0,
        moments_dtype=moments_dtype(getattr(cfg, "optim_moments_dtype", "float32")),
    )


def moments_dtype(name: str) -> Optional[torch.dtype]:
    """BertAdam's ``moments_dtype`` for ``cfg.optim_moments_dtype``: None
    (the parameters' float32) for "float32", else that floating type."""
    if name == "float32":
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"optim_moments_dtype must name a floating type, got {name!r}")
    return dtype


def trainable(params: Params) -> Params:
    """Mark every floating leaf of ``params`` as a leaf that requires grad
    (in place) and return the tree."""
    for _, leaf in tree_leaves_with_path(params):
        if leaf.is_floating_point():
            leaf.requires_grad_(True)
    return params


LossFn = Callable[..., Tuple[torch.Tensor, Tuple[Params, Dict[str, torch.Tensor]]]]


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient unchanged when
    the global norm ‖g‖ < ``max_norm``, else ``g / ‖g‖ * max_norm``
    (``clip_grad_norm_`` divides by ‖g‖ + 1e-6 instead).  No host sync;
    returns ‖g‖."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_train_step(loss_fn: LossFn, optimizer: BertAdam,
                    extra_optimizer: Optional[torch.optim.Optimizer] = None,
                    grad_clip: float = 0.0, custom_step=None):
    """``(state, batch) -> (state, metrics)``: one eager step.

    ``loss_fn(params, extra, aux, batch, generator) -> (loss, (new_aux,
    metrics))``; one backward differentiates the parameters and ``extra``
    together, then ``optimizer`` steps the parameters and
    ``extra_optimizer`` the ``extra`` leaves (``ccmh``'s two updates of
    one step).  ``grad_clip`` > 0 clips the gradients of ``optimizer``'s
    parameters by their global norm first (``ccmh`` chains
    ``clip_by_global_norm`` before BertAdam).  ``metrics`` holds detached
    device scalars, ``loss`` among them (reading them synchronises with the
    card, so the caller decides when).  ``custom_step``, a method's own
    ``(state, batch) -> (state, metrics)`` (DGHDGH's sequenced mode, built
    by ``Method.custom_step``), replaces the generic body."""
    if custom_step is not None:
        return custom_step
    optimizers = [optimizer] + ([extra_optimizer] if extra_optimizer is not None else [])

    def step_fn(state: TrainState, batch: Dict[str, Any]):
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        loss, (new_aux, metrics) = loss_fn(state.params, state.extra, state.aux, batch,
                                           state.generator)
        loss.backward()
        if grad_clip > 0:
            clip_by_global_norm_([p.grad for group in optimizer.param_groups
                                  for p in group["params"] if p.grad is not None], grad_clip)
        for opt in optimizers:
            opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        state.aux = new_aux
        state.step += 1
        return state, metrics

    return step_fn
