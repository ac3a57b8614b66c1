"""Weights-only ``.npz`` checkpoints in ``ccmh``'s Trainer format.

Port of the ``.npz`` branch of ``ccmh/train/trainer.py`` ``restore_state``
and of the file that ``Trainer.save_checkpoint`` writes: one ``.npz``
whose flat ``a/b/c`` keys hold ``params/...`` (``params/clip/...`` plus
the method's head trees), ``extra/...``, ``aux/...`` and ``step``.  A
checkpoint written by the ``ccmh`` Trainer loads here as it is, and one
written here loads in ``ccmh``.  Reference ``.pth`` imports and orbax
full-state directories are not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ccmh_torch.bridge import params_to_jax
from ccmh_torch.clip.convert import flatten, unflatten

Params = Dict[str, Any]


def load_checkpoint(path: str) -> Params:
    """Read a checkpoint -> {"params", "extra", "aux", "step"} as numpy
    trees (hand ``params`` to ``bridge.params_from_jax``)."""
    if path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: reference .pth import is not ported to ccmh_torch yet "
            "(convert it with ccmh and save an .npz)")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax state_ckpt directories are not ported to "
            "ccmh_torch yet (save an .npz with Trainer.save_checkpoint)")
    with np.load(path, allow_pickle=False) as data:
        tree = unflatten({k: data[k] for k in data.files})
    if "params" not in tree:
        raise ValueError(f"{path} holds no params/... arrays (keys: {sorted(tree)})")
    return {"params": tree["params"], "extra": tree.get("extra") or None,
            "aux": tree.get("aux", {}), "step": int(tree.get("step", 0))}


def save_checkpoint(path: str, params: Params, extra: Optional[Params] = None,
                    aux: Optional[Params] = None, step: int = 0) -> None:
    """Write the Trainer's ``.npz`` layout from trees of tensors or arrays."""
    tree = {"params": params, "extra": extra if extra is not None else {},
            "aux": aux if aux is not None else {}, "step": np.asarray(step)}
    np.savez(path, **flatten(params_to_jax(tree)))
