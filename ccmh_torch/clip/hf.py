"""HuggingFace ``CLIPModel`` layout interchange (port of the state-dict half
of ``ccmh/clip/hf.py``), without ``transformers``.

* :func:`load_hf_clip` — an HF-layout state dict, or an HF checkpoint
  directory (``config.json`` + ``model.safetensors`` or
  ``pytorch_model.bin``), -> (the port's parameter tree, ClipConfig).  The
  HF keys are renamed to the OpenAI layout (q/k/v packed into
  ``in_proj_weight``, projections transposed) and ``clip/convert.py``
  does the rest.  A directory is read by this module itself: the head
  counts from ``config.json``, the weights by ``torch.load`` or by
  :func:`read_safetensors`, a reader of the published safetensors layout.
* :func:`to_hf_state_dict` — the inverse, a parameter tree -> HF keys.

The head counts: a state dict carries none, so the OpenAI convention
(head_dim 64) stands; a directory's ``config.json`` overrides the text
tower's, and a vision head count the port cannot represent (it derives
``vision_heads`` as width // 64) raises.  Only ViT CLIPs exist in the HF
layout.  Building a live ``transformers.CLIPModel`` (``ccmh``'s
``to_hf_model`` and its CLI) needs ``transformers`` and is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ccmh_torch.clip.convert import convert_state_dict, _to_np
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.device import DeviceLike

Params = Dict[str, Any]

_LAYER_RE = re.compile(r"^(text_model|vision_model)\.encoder\.layers\.(\d+)\.(.+)$")

# per-layer suffix renames (HF -> OpenAI); attention q/k/v handled separately
_SUFFIX = {
    "layer_norm1.weight": "ln_1.weight",
    "layer_norm1.bias": "ln_1.bias",
    "layer_norm2.weight": "ln_2.weight",
    "layer_norm2.bias": "ln_2.bias",
    "self_attn.out_proj.weight": "attn.out_proj.weight",
    "self_attn.out_proj.bias": "attn.out_proj.bias",
    "mlp.fc1.weight": "mlp.c_fc.weight",
    "mlp.fc1.bias": "mlp.c_fc.bias",
    "mlp.fc2.weight": "mlp.c_proj.weight",
    "mlp.fc2.bias": "mlp.c_proj.bias",
}

_TOP = {
    "text_model.embeddings.token_embedding.weight": "token_embedding.weight",
    "text_model.embeddings.position_embedding.weight": "positional_embedding",
    "text_model.final_layer_norm.weight": "ln_final.weight",
    "text_model.final_layer_norm.bias": "ln_final.bias",
    "vision_model.embeddings.class_embedding": "visual.class_embedding",
    "vision_model.embeddings.patch_embedding.weight": "visual.conv1.weight",
    "vision_model.embeddings.position_embedding.weight": "visual.positional_embedding",
    # transformers ships the historical "pre_layrnorm" typo; a corrected
    # spelling is accepted too
    "vision_model.pre_layrnorm.weight": "visual.ln_pre.weight",
    "vision_model.pre_layrnorm.bias": "visual.ln_pre.bias",
    "vision_model.pre_layernorm.weight": "visual.ln_pre.weight",
    "vision_model.pre_layernorm.bias": "visual.ln_pre.bias",
    "vision_model.post_layernorm.weight": "visual.ln_post.weight",
    "vision_model.post_layernorm.bias": "visual.ln_post.bias",
    "logit_scale": "logit_scale",
}

# CLIPTextConfig's and CLIPVisionConfig's defaults, which a saved
# config.json may leave out
_DEFAULT_HEADS = {"text_config": 8, "vision_config": 12}


def hf_to_openai_state_dict(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """HF ``CLIPModel`` state dict -> OpenAI-layout state dict (numpy)."""
    out: Dict[str, np.ndarray] = {}
    qkv: Dict[Tuple[str, int, str], Dict[str, np.ndarray]] = {}
    for key, value in sd.items():
        if key.endswith("position_ids"):        # non-parameter buffer
            continue
        if key in _TOP:
            out[_TOP[key]] = _to_np(value)
            continue
        if key == "text_projection.weight":
            # HF Linear(width->embed, no bias) acts x @ W^T; OpenAI stores
            # the [width, embed] matrix applied as x @ P
            out["text_projection"] = _to_np(value).T
            continue
        if key == "visual_projection.weight":
            out["visual.proj"] = _to_np(value).T
            continue
        m = _LAYER_RE.match(key)
        if m is None:
            raise ValueError(f"unrecognized HF CLIP key: {key!r}")
        tower, i, suffix = m.group(1), int(m.group(2)), m.group(3)
        prefix = "transformer" if tower == "text_model" else "visual.transformer"
        oai = f"{prefix}.resblocks.{i}."
        if suffix in _SUFFIX:
            out[oai + _SUFFIX[suffix]] = _to_np(value)
            continue
        qm = re.match(r"^self_attn\.([qkv])_proj\.(weight|bias)$", suffix)
        if qm is None:
            raise ValueError(f"unrecognized HF CLIP key: {key!r}")
        qkv.setdefault((prefix, i, qm.group(2)), {})[qm.group(1)] = _to_np(value)
    for (prefix, i, kind), parts in qkv.items():
        if set(parts) != {"q", "k", "v"}:
            raise ValueError(f"incomplete q/k/v set for {prefix}.resblocks.{i} ({kind})")
        name = "in_proj_weight" if kind == "weight" else "in_proj_bias"
        out[f"{prefix}.resblocks.{i}.attn.{name}"] = np.concatenate(
            [parts["q"], parts["k"], parts["v"]], axis=0)
    if "vision_model.embeddings.patch_embedding.weight" in sd and \
            "visual.ln_pre.weight" not in out:
        raise ValueError("HF vision tower missing pre-LayerNorm weights")
    return out


def _looks_like_hf(sd: Dict[str, Any]) -> bool:
    return any(k.startswith(("text_model.", "vision_model.")) for k in sd)


# the safetensors element types, by their names in the header
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}.  The layout: an 8-byte
    little-endian header length, a JSON header {name: {"dtype", "shape",
    "data_offsets": [begin, end]}} (and an optional "__metadata__"), then
    the raw little-endian buffers, the offsets counted from the header's
    end."""
    with open(path, "rb") as fh:
        (n_header,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n_header))
        data = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: tensor {name!r} lies outside the file")
        flat = (torch.frombuffer(bytearray(data[begin:end]), dtype=dtype) if end > begin
                else torch.empty((0,), dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def read_hf_dir(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """An HF checkpoint directory -> (its state dict, {"text_config": text
    heads, "vision_config": vision heads} from config.json)."""
    with open(os.path.join(path, "config.json")) as fh:
        config = json.load(fh)
    heads = {tower: (config.get(tower) or {}).get("num_attention_heads", default)
             for tower, default in _DEFAULT_HEADS.items()}
    safetensors = os.path.join(path, "model.safetensors")
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(safetensors):
        return read_safetensors(safetensors), heads
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True), heads
    raise FileNotFoundError(f"{path} holds neither model.safetensors nor pytorch_model.bin "
                            "(sharded checkpoints are not read)")


def load_hf_clip(source, device: DeviceLike = "cuda") -> Tuple[Params, ClipConfig]:
    """HF CLIP (an HF-layout state dict, or a checkpoint directory) ->
    (tree of tensors on ``device``, ClipConfig).  A directory's config.json
    sets the head counts; a state dict assumes head_dim 64."""
    heads = None
    if isinstance(source, dict):
        sd = source
    else:
        sd, heads = read_hf_dir(source)
    params, cfg = convert_state_dict(hf_to_openai_state_dict(sd), device=device)
    if heads is not None:
        # the config is authoritative: override the text heads, and refuse
        # a vision head count that width // 64 does not give
        if heads["text_config"] != cfg.transformer_heads:
            cfg = dataclasses.replace(cfg, transformer_heads=heads["text_config"])
        if heads["vision_config"] != cfg.vision_heads:
            raise ValueError(
                f"HF vision tower uses {heads['vision_config']} attention heads but "
                f"width {cfg.vision_width} implies {cfg.vision_heads} at the "
                "OpenAI head_dim of 64: this architecture cannot be represented")
    return params, cfg


def _unstack(blocks: Params, i: int) -> Params:
    return {k: (_unstack(v, i) if isinstance(v, dict) else _to_np(v[i]))
            for k, v in blocks.items()}


def to_hf_state_dict(params: Params, cfg: ClipConfig) -> Dict[str, np.ndarray]:
    """The port's CLIP tree (tensors or arrays) -> HF ``CLIPModel`` state
    dict (float32 numpy), the inverse of :func:`hf_to_openai_state_dict`
    and the conversion: blocks unstacked, packed qkv split into q/k/v,
    the [W, 3, P, P] conv restored from the patchify matrix.  A
    ModifiedResNet tree raises: HF's ``CLIPModel`` has no such tower."""
    if cfg.is_resnet:
        raise ValueError("HF CLIPModel has no ModifiedResNet tower; only ViT "
                         "CLIPs can be exported")
    v, t = params["visual"], params["text"]
    P, W = cfg.vision_patch_size, cfg.vision_width
    sd: Dict[str, np.ndarray] = {
        "logit_scale": _to_np(params["logit_scale"]),
        "text_projection.weight": _to_np(t["text_projection"]).T,
        "visual_projection.weight": _to_np(v["proj"]).T,
        "text_model.embeddings.token_embedding.weight": _to_np(t["token_embedding"]),
        "text_model.embeddings.position_embedding.weight": _to_np(t["positional_embedding"]),
        "text_model.final_layer_norm.weight": _to_np(t["ln_final"]["scale"]),
        "text_model.final_layer_norm.bias": _to_np(t["ln_final"]["bias"]),
        "vision_model.embeddings.class_embedding": _to_np(v["class_embedding"]),
        "vision_model.embeddings.position_embedding.weight":
            _to_np(v["positional_embedding"]),
        # patch_w is [(ph, pw, c), W]; the conv wants [W, C, Ph, Pw]
        "vision_model.embeddings.patch_embedding.weight":
            _to_np(v["patch_w"]).reshape(P, P, 3, W).transpose(3, 2, 0, 1),
        "vision_model.pre_layrnorm.weight": _to_np(v["ln_pre"]["scale"]),
        "vision_model.pre_layrnorm.bias": _to_np(v["ln_pre"]["bias"]),
        "vision_model.post_layernorm.weight": _to_np(v["ln_post"]["scale"]),
        "vision_model.post_layernorm.bias": _to_np(v["ln_post"]["bias"]),
    }
    for tower, blocks, n_layers in (("text_model", t["blocks"], cfg.transformer_layers),
                                    ("vision_model", v["blocks"], cfg.vision_layers)):
        for i in range(n_layers):
            b = _unstack(blocks, i)
            pre = f"{tower}.encoder.layers.{i}."
            in_w = b["attn"]["qkv_w"].T       # [3W, W], rows q | k | v
            in_b = b["attn"]["qkv_b"]
            width = in_w.shape[1]
            for j, name in enumerate("qkv"):
                sd[pre + f"self_attn.{name}_proj.weight"] = in_w[j * width:(j + 1) * width]
                sd[pre + f"self_attn.{name}_proj.bias"] = in_b[j * width:(j + 1) * width]
            sd[pre + "self_attn.out_proj.weight"] = b["attn"]["out_w"].T
            sd[pre + "self_attn.out_proj.bias"] = b["attn"]["out_b"]
            sd[pre + "layer_norm1.weight"] = b["ln_1"]["scale"]
            sd[pre + "layer_norm1.bias"] = b["ln_1"]["bias"]
            sd[pre + "layer_norm2.weight"] = b["ln_2"]["scale"]
            sd[pre + "layer_norm2.bias"] = b["ln_2"]["bias"]
            sd[pre + "mlp.fc1.weight"] = b["mlp"]["fc_w"].T
            sd[pre + "mlp.fc1.bias"] = b["mlp"]["fc_b"]
            sd[pre + "mlp.fc2.weight"] = b["mlp"]["proj_w"].T
            sd[pre + "mlp.fc2.bias"] = b["mlp"]["proj_b"]
    return sd
