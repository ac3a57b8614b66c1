"""BertAdam as a ``torch.optim.Optimizer`` (port of ``ccmh/train/optim.py``,
the reference's model/base/optimization.py:26-168).

It differs from stock Adam/AdamW where that shifts the trajectory:

* **no bias correction** on either moment;
* **per-parameter-tensor gradient clipping** at ``max_grad_norm``, not a
  global norm; a group marked ``block_stacked`` holds the transformer
  blocks stacked on axis 0, each layer a separate tensor in the reference,
  so it clips **per layer slice** (``ccmh``'s ``block_stacked_tree``);
* weight decay added to the *update* (``update += wd * p``) before the lr,
  on every parameter;
* the schedule multiplier evaluated at ``progress = step / t_total`` before
  the step counter moves, so the first warmup step runs at lr 0;
* per-group learning rates (the CLIP backbone at ``clip_lr``, the heads at
  ``lr``: ``param_groups_for``).

A parameter whose ``.grad`` is None (one the loss never reaches, like
``clip.logit_scale``) takes a zero gradient, as in ``ccmh``, where its
gradient is an exact zero: its moments decay and weight decay still moves
it every step.  A textbook optimizer would skip it and drift from ``ccmh``.

The schedule is computed in float32 as ``ccmh`` computes it.

``moments_dtype`` (``--set optim_moments_dtype=bfloat16``) stores ``m`` and
``v`` in a reduced type, ``ccmh``'s opt-in departure from the reference:
the update still runs in fp32 (cast up, accumulate, cast down), and it
reads the moments as stored, so it is ``ccmh``'s step; storage and the
optimizer's memory traffic halve.  ``state_dict`` carries them in that
type and :meth:`BertAdam.load_state_dict` keeps it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ccmh_torch.bridge import tensor_from_numpy

Params = Dict[str, Any]


def _f32(x) -> np.float32:
    return np.float32(x)


def warmup_cosine(progress: np.float32, warmup: float) -> np.float32:
    if progress < _f32(warmup):
        return progress / _f32(warmup)
    return _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * progress))


def warmup_constant(progress: np.float32, warmup: float) -> np.float32:
    return progress / _f32(warmup) if progress < _f32(warmup) else _f32(1.0)


def warmup_linear(progress: np.float32, warmup: float) -> np.float32:
    if progress < _f32(warmup):
        return progress / _f32(warmup)
    return max((progress - _f32(1.0)) / _f32(warmup - 1.0), _f32(0.0))


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


class BertAdam(torch.optim.Optimizer):
    """BertAdam over param groups; a group may set ``lr`` and
    ``block_stacked`` (clip per axis-0 slice) and carries ``paths`` (the
    tree path of each of its parameters, for :meth:`load_tree_state`).
    The step counter lives in every group (``step``), so it travels with
    ``state_dict``.  ``moments_dtype`` (None: the parameter's type) stores
    ``m`` and ``v`` reduced."""

    def __init__(self, params, lr: float = 1e-3, *, warmup: float = -1.0,
                 t_total: int = -1, schedule: str = "warmup_cosine", b1: float = 0.9,
                 b2: float = 0.98, eps: float = 1e-6, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, moments_dtype: Optional[torch.dtype] = None):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        defaults = dict(lr=lr, block_stacked=False, step=0)
        super().__init__(params, defaults)
        self.warmup = warmup
        self.t_total = t_total
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.moments_dtype = moments_dtype

    def lr_scale(self, step: int) -> np.float32:
        """The schedule multiplier for the update taken at ``step``."""
        if self.t_total <= 0:
            return _f32(1.0)
        progress = _f32(step) / _f32(self.t_total)
        return SCHEDULES[self.schedule](progress, self.warmup)

    def _clip(self, g: torch.Tensor, stacked: bool) -> torch.Tensor:
        if self.max_grad_norm <= 0:
            return g
        if stacked and g.ndim >= 1:
            norm = torch.linalg.vector_norm(g, dim=tuple(range(1, g.ndim)), keepdim=True)
        else:
            norm = torch.linalg.vector_norm(g)
        scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
        return g * scale

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        # constants rounded to float32 as ccmh's weakly typed Python floats
        # are: 1 - b1 is taken in double first
        b1, b2 = _f32(self.b1), _f32(self.b2)
        c1, c2 = _f32(1 - self.b1), _f32(1 - self.b2)
        for group in self.param_groups:
            step_size = _f32(group["lr"]) * self.lr_scale(group["step"])
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = self._clip(g, group["block_stacked"])
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p, dtype=self.moments_dtype)
                    st["v"] = torch.zeros_like(p, dtype=self.moments_dtype)
                if self.moments_dtype is None:
                    m = st["m"].mul_(b1).add_(g * c1)
                    v = st["v"].mul_(b2).add_(g * c2 * g)
                else:
                    # accumulate in fp32: bf16's 8-bit mantissa would swallow
                    # the (1 - b2)-scale increments of v; then read back the
                    # moments as stored, as ccmh does
                    st["m"].copy_(st["m"].float().mul_(b1).add_(g * c1))
                    st["v"].copy_(st["v"].float().mul_(b2).add_(g * c2 * g))
                    m, v = st["m"].float(), st["v"].float()
                upd = m / (v.sqrt() + self.eps)
                if self.weight_decay > 0:
                    upd = upd + self.weight_decay * p
                p.sub_(float(step_size) * upd)
            group["step"] += 1
        return loss

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.Optimizer``'s, which casts every state tensor to its
        parameter's type; reduced moments are cast back (exactly: they
        went up to the parameter's fp32 unchanged)."""
        super().load_state_dict(state_dict)
        if self.moments_dtype is not None:
            for st in self.state.values():
                for name in ("m", "v"):
                    if name in st:
                        st[name] = st[name].to(self.moments_dtype)

    def load_tree_state(self, m: Params, v: Params, step: int) -> None:
        """Take ``ccmh``'s BertAdam state: the moment trees ``m`` and ``v``
        (numpy, congruent with the params; ``ml_dtypes.bfloat16`` leaves
        of reduced moments come across bit for bit) and its step counter."""
        for group in self.param_groups:
            group["step"] = int(step)
            for p, path in zip(group["params"], group["paths"]):
                st = self.state[p]
                for name, tree in (("m", m), ("v", v)):
                    st[name] = tensor_from_numpy(_get(tree, path)).to(
                        device=p.device, dtype=self.moments_dtype or p.dtype)


def _get(tree: Params, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves_with_path(tree: Params, prefix: Tuple[Any, ...] = ()
                          ) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) of every leaf in order; a path holds dict keys and, for
    lists (MITH's residual MLP layers), integer indices."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from tree_leaves_with_path(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def param_groups_for(params: Params, default_lr: float, overrides: Dict[str, float]
                     ) -> List[Dict[str, Any]]:
    """BertAdam param groups for ``ccmh``'s param tree: top-level keys in
    ``overrides`` take their own lr (``lr_tree_for``), and leaves under a
    ``blocks`` key clip per layer (``block_stacked_tree``)."""
    groups: Dict[Tuple[float, bool], Dict[str, Any]] = {}
    for path, leaf in tree_leaves_with_path(params):
        lr = overrides.get(path[0], default_lr)
        stacked = "blocks" in path
        group = groups.setdefault((lr, stacked), {"params": [], "paths": [], "lr": lr,
                                                  "block_stacked": stacked})
        group["params"].append(leaf)
        group["paths"].append(path)
    return list(groups.values())


def bert_adam_for(params: Params, default_lr: float, overrides: Optional[Dict[str, float]] = None,
                  **kw) -> BertAdam:
    return BertAdam(param_groups_for(params, default_lr, overrides or {}), default_lr, **kw)
