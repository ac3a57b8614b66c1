"""Training state and the train step (port of ``ccmh/train/state.py``).

``ccmh`` threads a functional TrainState through one jitted XLA program per
step.  PyTorch runs eagerly: the state holds the parameter tree (leaf
tensors with ``requires_grad``), the method's ``extra`` and ``aux`` trees,
the step counter and the ``torch.Generator`` of the step's randomness, and
the step is forward, loss, backward, the method's global gradient clip
where it has one (DPSIH's), and one BertAdam step, updating the parameters
in place.  Under an active mesh (``parallel/mesh.py``) the CLIP gradients
are summed over the data axis right after ``backward``, before any clip
(those of leaves sharded over the data axis, ``parallel/fsdp.py``, were
reduce-scattered in ``backward`` itself).  A method's loss-side ``extra``
parameters (DSPH's proxies) take the same backward and their own optimizer
(``ccmh``'s ``extra_tx``), stepped after BertAdam.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ccmh_torch.config import Config
from ccmh_torch.parallel.mesh import active_mesh, shard_axes, sum_over_shards, sync_gradients
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


def clip_params_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm_` of the gradients of ``params`` (those
    that have one).  A leaf sharded over mesh axes (``parallel/tp.py``'s
    model axis, ``parallel/fsdp.py``'s data axis) counts by its squares
    summed over the ranks of those axes and a replicated leaf once, so
    every rank clips by the norm of the whole gradient."""
    params = [p for p in params if p.grad is not None]
    mesh = active_mesh()
    by_axes: Dict[Tuple[str, ...], list] = {}
    for p in params:
        by_axes.setdefault(tuple(sorted(shard_axes(p))), []).append(p)
    if mesh is None or set(by_axes) <= {()}:
        return clip_by_global_norm_([p.grad for p in params], max_norm)
    zero = torch.zeros((), device=params[0].grad.device)
    sharded = zero
    for axes in (("model",), ("data",), ("data", "model")):
        if axes in by_axes:
            part = sum(((p.grad * p.grad).sum() for p in by_axes[axes]), zero)
            sharded = sharded + sum_over_shards(part, axes, mesh)
    norm = torch.sqrt(sharded + sum(((p.grad * p.grad).sum() for p in by_axes.get((), [])),
                                    zero))
    keep = norm < max_norm
    for p in params:
        p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * max_norm))
    return norm


class TrainStep:
    """``(state, batch) -> (state, metrics)``: one eager step.

    ``loss_fn(params, extra, aux, batch, generator) -> (loss, (new_aux,
    metrics))``.  The step is three parts, each under a
    ``torch.profiler.record_function`` range (a profile of the step, and
    ``ccmh_torch/tools/step_split.py``'s timings, split it by these; the
    towers inside the loss run under "towers", ``methods/base.py``
    ``clip_embeds``):

    * :meth:`forward` ("heads+loss"): zero the gradients, the loss forward;
    * :meth:`backward` ("backward"): one backward differentiates the
      parameters and ``extra`` together, then the mesh's gradient sum;
    * :meth:`optimize` ("optimizer"): ``grad_clip`` > 0 clips the gradients
      of ``optimizer``'s parameters by their global norm (``ccmh`` chains
      ``clip_by_global_norm`` before BertAdam), then ``optimizer`` steps
      the parameters and ``extra_optimizer`` the ``extra`` leaves
      (``ccmh``'s two updates of one step).

    ``metrics`` holds detached device scalars, ``loss`` among them (reading
    them synchronises with the card, so the caller decides when)."""

    def __init__(self, loss_fn: LossFn, optimizer: BertAdam,
                 extra_optimizer: Optional[torch.optim.Optimizer] = None,
                 grad_clip: float = 0.0):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.optimizers = [optimizer] + ([extra_optimizer] if extra_optimizer is not None
                                         else [])
        self.grad_clip = grad_clip

    def forward(self, state: TrainState, batch: Dict[str, Any]):
        """``(loss, (new_aux, metrics))`` with the gradients zeroed."""
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)
        with torch.profiler.record_function("heads+loss"):
            return self.loss_fn(state.params, state.extra, state.aux, batch, state.generator)

    def backward(self, state: TrainState, loss: torch.Tensor) -> None:
        with torch.profiler.record_function("backward"):
            loss.backward()
            sync_gradients(state.params)

    def optimize(self) -> None:
        with torch.profiler.record_function("optimizer"):
            if self.grad_clip > 0:
                clip_params_by_global_norm_([p for group in self.optimizer.param_groups
                                             for p in group["params"]], self.grad_clip)
            for opt in self.optimizers:
                opt.step()

    @staticmethod
    def finish(state: TrainState, loss: torch.Tensor, new_aux, metrics):
        """Take the step's ``aux`` and count it; ``(state, metrics)``."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        state.aux = new_aux
        state.step += 1
        return state, metrics

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        loss, (new_aux, metrics) = self.forward(state, batch)
        self.backward(state, loss)
        self.optimize()
        return self.finish(state, loss, new_aux, metrics)


def make_train_step(loss_fn: LossFn, optimizer: BertAdam,
                    extra_optimizer: Optional[torch.optim.Optimizer] = None,
                    grad_clip: float = 0.0, custom_step=None):
    """The :class:`TrainStep` of ``loss_fn`` and the optimizers.
    ``custom_step``, a method's own ``(state, batch) -> (state, metrics)``
    (DGHDGH's sequenced mode, built by ``Method.custom_step``), replaces
    the generic body."""
    if custom_step is not None:
        return custom_step
    return TrainStep(loss_fn, optimizer, extra_optimizer, grad_clip)
