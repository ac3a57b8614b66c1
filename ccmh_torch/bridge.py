"""The weight bridge between ``ccmh`` parameter trees and the port's state.

``ccmh`` keeps parameters as nested dicts of arrays: the CLIP tree of
``init_clip_params`` (stacked ``blocks/*`` with a leading layer axis, flat
[p*p*3, W] ``patch_w``, weights stored [in, out]) plus the method's head
trees (``img_head`` / ``txt_head``).  The port keeps exactly that layout
with ``torch.Tensor`` leaves, so the bridge is a leaf-wise conversion that
preserves dtypes and shapes: numpy in, tensors out, and back.  Neither
direction imports ``ccmh`` or JAX; callers hand over numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the JAX side).  Lists in a tree
(MITH's residual MLP layers) stay lists.  ``ccmh``'s BertAdam
state (the ``m`` and ``v`` trees and ``step``, as numpy) goes into the
port's optimizer with ``BertAdam.load_tree_state`` (train/optim.py).
numpy has no bfloat16 of its own: ``ccmh``'s bf16 leaves (reduced
optimizer moments) arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses, and cross through a 16-bit view
(:func:`tensor_from_numpy`), bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ccmh_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def tensor_from_numpy(a) -> torch.Tensor:
    """A host tensor holding a copy of array ``a``; a bfloat16 array
    (``ml_dtypes``, read by its name: the port does not import it) keeps
    its bits and comes out ``torch.bfloat16``."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Params, device: DeviceLike = "cuda") -> Params:
    """Nested dict of numpy arrays (``ccmh``'s tree) -> same tree of tensors
    on ``device``, dtypes and shapes unchanged."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return tensor_from_numpy(node).to(dev)

    return conv(tree)


def params_to_jax(tree: Params) -> Params:
    """Tree of tensors -> same tree of numpy arrays (host copies), the form
    ``ccmh`` takes (``jax.tree.map(jnp.asarray, ...)``) and writes to
    ``.npz``."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu()
            # numpy has no bfloat16: such leaves widen (exactly) to float32
            return (node.float() if node.dtype == torch.bfloat16 else node).numpy()
        return np.asarray(node)

    return conv(tree)
