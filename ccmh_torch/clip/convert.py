"""Torch-free ``.npz`` persistence of parameter trees (port of the ``.npz``
half of ``ccmh/clip/convert.py``).

The file layout is ``ccmh``'s: one array per leaf under its flat
``a/b/c`` key path, stacked transformer blocks included, so the two
packages read each other's files.  A list in a tree (MITH's residual MLP
layers) is stored one key per element, ``layers/0/...``, and read back as
a list; ``ccmh`` writes such a list as one pickled object array, which its
own ``allow_pickle=False`` reader refuses, so neither package reads
the other's MITH checkpoints.  The architecture is inferred from the
array shapes.  Conversion of OpenAI ``.pt`` archives and HuggingFace
checkpoints is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np

from ccmh_torch.bridge import params_from_jax, params_to_jax
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts (and lists) of arrays -> {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, (dict, list)):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            flat.update(flatten(v, f"{prefix}{k}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _lists(node):
    """Dicts keyed "0", "1", ... -> lists (what :func:`flatten` wrote)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten(flat: Dict[str, np.ndarray]) -> Params:
    """{"a/b/c": array} -> nested dict (and lists) of numpy arrays."""
    tree: Params = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return _lists(tree)


def infer_clip_config(clip: Params) -> ClipConfig:
    """ClipConfig from the shapes of a CLIP tree (numpy arrays or tensors)."""
    v, t = clip["visual"], clip["text"]
    if "stem" in v:
        raise NotImplementedError(
            "ModifiedResNet vision towers are not ported to ccmh_torch yet")
    patch = int(math.isqrt(v["patch_w"].shape[0] // 3))
    grid = int(math.isqrt(v["positional_embedding"].shape[0] - 1))
    return ClipConfig(
        embed_dim=t["text_projection"].shape[1],
        image_resolution=patch * grid,
        vision_layers=v["blocks"]["ln_1"]["scale"].shape[0],
        vision_width=v["patch_w"].shape[1],
        vision_patch_size=patch,
        context_length=t["positional_embedding"].shape[0],
        vocab_size=t["token_embedding"].shape[0],
        transformer_width=t["token_embedding"].shape[1],
        transformer_heads=t["token_embedding"].shape[1] // 64,
        transformer_layers=t["blocks"]["ln_1"]["scale"].shape[0],
    )


def save_params_npz(path: str, params: Params) -> None:
    """Write a tree of tensors (or arrays) in ``ccmh``'s flat-key layout."""
    np.savez(path, **flatten(params_to_jax(params)))


def load_params_npz(path: str, device: DeviceLike = "cuda") -> Tuple[Params, ClipConfig]:
    """Read a CLIP ``.npz`` -> (tree of tensors on ``device``, ClipConfig)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        tree = unflatten({k: data[k] for k in data.files})
    return params_from_jax(tree, device=dev), infer_clip_config(tree)
