"""CLIP tower files: OpenAI ``.pt`` conversion and ``.npz`` persistence
(port of ``ccmh/clip/convert.py``).

* :func:`convert_state_dict` — an OpenAI CLIP state dict (the reference's
  model/base/model.py:415-455 layout) -> the port's parameter tree and the
  :class:`ClipConfig` inferred from its shapes, as ``build_model`` infers
  it: per-layer weights stacked on a leading layer axis, [out, in] torch
  matrices transposed to [in, out], the patch conv flattened in
  (ph, pw, channel) order.  An RN-family file (no ``visual.proj``) gives
  the ModifiedResNet tower (``clip/resnet.py``), its ``vision_layers`` a
  tuple.  The conversion runs in numpy on the host and ``ccmh``'s
  arithmetic, so both packages get the same bits.
* :func:`convert_torch_checkpoint` — a ``.pt`` on disk: a TorchScript
  archive (OpenAI's release files, through ``torch.jit.load``) or a plain
  state dict (``torch.load(weights_only=True)``); an HF-layout state dict
  inside a ``.pt`` goes through ``clip/hf.py``.
* :func:`load_clip_params` — ``--clip-path``: ``.npz``, an HF checkpoint
  directory, or a ``.pt``.
* ``.npz`` persistence in ``ccmh``'s layout: one array per leaf under its
  flat ``a/b/c`` key path, stacked transformer blocks included, so the two
  packages read each other's files.  A list in a tree (MITH's residual MLP
  layers) is stored one key per element, ``layers/0/...``, and read back
  as a list; ``ccmh`` writes such a list as one pickled object array,
  which its own ``allow_pickle=False`` reader refuses, so neither package
  reads the other's MITH checkpoints.  The ModifiedResNet stages
  (``layer1`` .. ``layer4``) stay dicts keyed by block index, as in
  ``ccmh``.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

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


# a ModifiedResNet stage: a dict keyed by block index in ccmh's layout
_RESNET_STAGE = re.compile(r"layer\d+")


def _lists(node, key: str = ""):
    """Dicts keyed "0", "1", ... -> lists (what :func:`flatten` wrote),
    except a ModifiedResNet stage."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v, k) for k, v in node.items()}
    if (node and not _RESNET_STAGE.fullmatch(key)
            and sorted(node) == sorted(map(str, range(len(node))))):
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
    """ClipConfig from the shapes of a CLIP tree (numpy arrays or tensors);
    a tree with a ``stem`` is a ModifiedResNet tower."""
    v, t = clip["visual"], clip["text"]
    text = dict(
        embed_dim=t["text_projection"].shape[1],
        context_length=t["positional_embedding"].shape[0],
        vocab_size=t["token_embedding"].shape[0],
        transformer_width=t["token_embedding"].shape[1],
        transformer_heads=t["token_embedding"].shape[1] // 64,
        transformer_layers=t["blocks"]["ln_1"]["scale"].shape[0],
    )
    if "stem" in v:
        spacial = int(math.isqrt(v["attnpool"]["positional_embedding"].shape[0] - 1))
        return ClipConfig(
            image_resolution=spacial * 32,
            vision_layers=tuple(len(v[f"layer{i}"]) for i in (1, 2, 3, 4)),
            vision_width=v["layer1"]["0"]["conv1"].shape[3],
            vision_patch_size=None,
            **text,
        )
    patch = int(math.isqrt(v["patch_w"].shape[0] // 3))
    grid = int(math.isqrt(v["positional_embedding"].shape[0] - 1))
    return ClipConfig(
        image_resolution=patch * grid,
        vision_layers=v["blocks"]["ln_1"]["scale"].shape[0],
        vision_width=v["patch_w"].shape[1],
        vision_patch_size=patch,
        **text,
    )


def _infer_config(sd: Dict[str, Any]) -> ClipConfig:
    """Shape-driven architecture inference (model/base/model.py:415-438);
    an RN-family state dict (no ``visual.proj``) selects the ModifiedResNet
    tower, as the reference's build_model does."""
    text = dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )
    if "visual.proj" not in sd:
        counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
                       for b in (1, 2, 3, 4))
        output_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        return ClipConfig(
            image_resolution=output_width * 32,
            vision_layers=counts,
            vision_width=sd["visual.layer1.0.conv1.weight"].shape[0],
            vision_patch_size=None,
            **text,
        )
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return ClipConfig(
        image_resolution=vision_patch_size * grid_size,
        vision_layers=len([k for k in sd if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
        vision_width=sd["visual.conv1.weight"].shape[0],
        vision_patch_size=vision_patch_size,
        **text,
    )


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _convert_blocks(sd: Dict[str, Any], prefix: str, n_layers: int) -> Params:
    """Per-layer torch weights -> stacked [L, ...] arrays."""
    def get(name: str) -> np.ndarray:
        return np.stack([_to_np(sd[f"{prefix}.resblocks.{i}.{name}"]) for i in range(n_layers)])

    def get_t(name: str) -> np.ndarray:   # torch's [out, in], applied as x @ W^T
        return np.stack([_to_np(sd[f"{prefix}.resblocks.{i}.{name}"]).T
                         for i in range(n_layers)])

    return {
        "ln_1": {"scale": get("ln_1.weight"), "bias": get("ln_1.bias")},
        "attn": {"qkv_w": get_t("attn.in_proj_weight"), "qkv_b": get("attn.in_proj_bias"),
                 "out_w": get_t("attn.out_proj.weight"), "out_b": get("attn.out_proj.bias")},
        "ln_2": {"scale": get("ln_2.weight"), "bias": get("ln_2.bias")},
        "mlp": {"fc_w": get_t("mlp.c_fc.weight"), "fc_b": get("mlp.c_fc.bias"),
                "proj_w": get_t("mlp.c_proj.weight"), "proj_b": get("mlp.c_proj.bias")},
    }


def _ln(sd: Dict[str, Any], prefix: str) -> Params:
    return {"scale": _to_np(sd[f"{prefix}.weight"]), "bias": _to_np(sd[f"{prefix}.bias"])}


def convert_state_dict_numpy(sd: Dict[str, Any]) -> Tuple[Params, ClipConfig]:
    """OpenAI CLIP state dict -> (numpy parameter tree, inferred config)."""
    cfg = _infer_config(sd)
    if cfg.is_resnet:
        from ccmh_torch.clip.resnet import convert_resnet_visual

        visual = convert_resnet_visual(sd, cfg.vision_layers)
    else:
        conv = _to_np(sd["visual.conv1.weight"])           # [W, 3, P, P]
        # [W, C, Ph, Pw] -> [Ph, Pw, C, W] -> [(ph, pw, c), W], patchify's order
        visual = {
            "patch_w": conv.transpose(2, 3, 1, 0).reshape(-1, cfg.vision_width),
            "class_embedding": _to_np(sd["visual.class_embedding"]),
            "positional_embedding": _to_np(sd["visual.positional_embedding"]),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _convert_blocks(sd, "visual.transformer", cfg.vision_layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": _to_np(sd["visual.proj"]),
        }
    params = {
        "visual": visual,
        "text": {
            "token_embedding": _to_np(sd["token_embedding.weight"]),
            "positional_embedding": _to_np(sd["positional_embedding"]),
            "blocks": _convert_blocks(sd, "transformer", cfg.transformer_layers),
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": _to_np(sd["text_projection"]),
        },
        # 0-d as in OpenAI's files (ccmh's .pth export writes it as [1])
        "logit_scale": _to_np(sd["logit_scale"]).reshape(()),
    }
    return params, cfg


def convert_state_dict(sd: Dict[str, Any], device: DeviceLike = "cuda"
                       ) -> Tuple[Params, ClipConfig]:
    """OpenAI CLIP state dict -> (tree of tensors on ``device``, config)."""
    params, cfg = convert_state_dict_numpy(sd)
    return params_from_jax(params, device=resolve_device(device)), cfg


def convert_torch_checkpoint(path: str, device: DeviceLike = "cuda"
                             ) -> Tuple[Params, ClipConfig]:
    """Load an OpenAI CLIP ``.pt``: a TorchScript archive (OpenAI's release
    files) or a saved state dict, read with ``weights_only=True``; an
    HF-layout state dict goes through ``clip/hf.py``."""
    from ccmh_torch.clip.hf import _looks_like_hf, load_hf_clip

    try:
        sd = dict(torch.jit.load(path, map_location="cpu").state_dict())
    except RuntimeError:                   # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if _looks_like_hf(sd):
        return load_hf_clip(sd, device=device)
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key, None)
    return convert_state_dict(sd, device=device)


def save_params_npz(path: str, params: Params) -> None:
    """Write a tree of tensors (or arrays) in ``ccmh``'s flat-key layout."""
    np.savez(path, **flatten(params_to_jax(params)))


def load_params_npz(path: str, device: DeviceLike = "cuda") -> Tuple[Params, ClipConfig]:
    """Read a CLIP ``.npz`` -> (tree of tensors on ``device``, ClipConfig)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        tree = unflatten({k: data[k] for k in data.files})
    return params_from_jax(tree, device=dev), infer_clip_config(tree)


def load_clip_params(path: str, device: DeviceLike = "cuda") -> Tuple[Params, ClipConfig]:
    """``--clip-path``: an ``.npz``, an HF checkpoint directory (config.json
    + model.safetensors or pytorch_model.bin, read without ``transformers``)
    or a ``.pt`` (TorchScript archive or state dict)."""
    if path.endswith(".npz"):
        return load_params_npz(path, device=device)
    if os.path.isdir(path):
        from ccmh_torch.clip.hf import load_hf_clip

        return load_hf_clip(path, device=device)
    return convert_torch_checkpoint(path, device=device)
