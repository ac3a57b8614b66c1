"""Import reference-trained model checkpoints (``.pth``) (port of
``ccmh/clip/import_ref.py``).

The reference trainer saves ``model.state_dict()`` every epoch
(train/base.py:225-227): the CLIP tower under ``clip.*`` and the method's
head modules (``image_hash.*`` / ``text_hash.*`` and others).  This
module maps such a state dict onto the port's parameter tree, so that a
reference-trained model can be tested, served or trained on here.

Covered, as in ``ccmh``: the LinearHash family (DSPH, DNpH, DMsH_LN,
DScPH, DDWSH, DDBH, DHaPH; model/modelbase.py:25-35), DNPH with its
``image_pre`` / ``text_pre`` label predictors, DCHMT's HashLayer (fc ->
128 and K Linear(128, 2) pairs, fused into the select-hash layout), DPBE's
Sequential(Linear, L2Norm) heads, TwDH's ModalityHash heads with the image
head's BatchNorm running statistics (state-dict buffers, which the port
keeps in ``aux``), and MITH's HashingModel.  DPSIH and DGHDGH raise: their
reference models do not run as committed, so no checkpoint of either
exists.

Everything is numpy on the host; ``bridge.params_from_jax`` moves a tree
to the device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ccmh_torch.clip.convert import convert_state_dict_numpy
from ccmh_torch.clip.model import ClipConfig

Params = Dict[str, Any]

# methods whose reference model keeps the plain Baseclip LinearHash heads
LINEAR_FAMILY = ("DSPH", "DNpH", "DMsH_LN", "DScPH", "DDWSH", "DDBH", "DHaPH")


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.array(t, copy=True)


def _linear(sd: Dict[str, Any], prefix: str) -> Params:
    """torch nn.Linear -> {w: [in, out], b: [out]} (y = x @ w + b)."""
    return {"w": _np(sd[f"{prefix}.weight"]).T, "b": _np(sd[f"{prefix}.bias"])}


def _heads_linear_family(sd) -> Params:
    return {"img_head": _linear(sd, "image_hash.fc"), "txt_head": _linear(sd, "text_hash.fc")}


def _heads_dnph(sd) -> Params:
    heads = _heads_linear_family(sd)
    heads["img_pre"] = _linear(sd, "image_pre.fc")
    heads["txt_pre"] = _linear(sd, "text_pre.fc")
    return heads


def _heads_dpbe(sd) -> Params:
    # Sequential(Linear, L2Norm): the Linear is module "0"
    return {"img_head": _linear(sd, "image_hash.0"), "txt_head": _linear(sd, "text_hash.0")}


def _select_hash(sd, module: str) -> Params:
    """DCHMT's HashLayer (model/DCHMT.py:8-28) -> the select-hash layout
    (pairs_w [128, K, 2], pairs_b [K, 2])."""
    fc = _linear(sd, f"{module}.fc")
    k = 0
    while f"{module}.hash_list.{k}.weight" in sd:
        k += 1
    if k == 0:
        raise KeyError(f"{module}.hash_list.0.weight")
    pairs_w = np.stack([_np(sd[f"{module}.hash_list.{i}.weight"]).T for i in range(k)], axis=1)
    pairs_b = np.stack([_np(sd[f"{module}.hash_list.{i}.bias"]) for i in range(k)])
    return {"fc_w": fc["w"], "fc_b": fc["b"], "pairs_w": pairs_w, "pairs_b": pairs_b}


def _heads_dchmt(sd) -> Params:
    return {"img_head": _select_hash(sd, "image_hash"), "txt_head": _select_hash(sd, "text_hash")}


def _modality_hash(sd, prefix: str, layernorm: bool) -> Params:
    """TwDH's ModalityHash (model/TwDH.py:55-84): of its one-token attention
    only the value path reaches the output (softmax over one key is 1)."""
    ipw = _np(sd[f"{prefix}.atten.in_proj_weight"])
    ipb = _np(sd[f"{prefix}.atten.in_proj_bias"])
    e = ipw.shape[1]
    p = {
        "v_w": ipw[2 * e:3 * e].T,
        "v_b": ipb[2 * e:3 * e],
        "out_w": _np(sd[f"{prefix}.atten.out_proj.weight"]).T,
        "out_b": _np(sd[f"{prefix}.atten.out_proj.bias"]),
        "fc2_w": _np(sd[f"{prefix}.fc2.weight"]).T,
        "fc2_b": _np(sd[f"{prefix}.fc2.bias"]),
    }
    p["ln" if layernorm else "bn"] = {"scale": _np(sd[f"{prefix}.norm.weight"]),
                                      "bias": _np(sd[f"{prefix}.norm.bias"])}
    return p


def _heads_twdh(sd) -> Params:
    return {"img_head": _modality_hash(sd, "img_hash", layernorm=False),
            "txt_head": _modality_hash(sd, "txt_hash", layernorm=True)}


def _aux_twdh(sd) -> Params:
    """The image head's BatchNorm running statistics (``aux["bn"]``)."""
    return {"bn": {
        "mean": _np(sd["img_hash.norm.running_mean"]),
        "var": _np(sd["img_hash.norm.running_var"]),
        "count": np.asarray(int(_np(sd["img_hash.norm.num_batches_tracked"])), np.int32),
    }}


def _stack_trees(trees):
    """Identically shaped nested dicts -> one dict of stacked arrays."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _heads_mith(sd) -> Params:
    """MITH's HashingModel (model/MITH.py:217-454) -> models/mith.py's tree:
    the shared GCL (``gcl_i`` and ``gcl_t`` are one module upstream), the
    per-modality LCTs with stacked transformer blocks, the bitwise hashing
    fused, the concept projections."""
    h = {k[len("hash."):]: v for k, v in sd.items() if k.startswith("hash.")}
    if not h:
        raise KeyError("hash.")

    def lin(prefix, bias=True):
        p = {"w": _np(h[f"{prefix}.weight"]).T}
        if bias:
            p["b"] = _np(h[f"{prefix}.bias"])
        return p

    def res_mlps(prefix):
        layers, i = [], 0
        while f"{prefix}.mlps.{i}.0.weight" in h:
            layers.append({"ln": {"scale": _np(h[f"{prefix}.lns.{i}.weight"]),
                                  "bias": _np(h[f"{prefix}.lns.{i}.bias"])},
                           "fc1": lin(f"{prefix}.mlps.{i}.0"),
                           "fc2": lin(f"{prefix}.mlps.{i}.3")})
            i += 1
        return {"layers": layers}

    def blocks(prefix):
        blks, i = [], 0
        while f"{prefix}.resblocks.{i}.ln_1.weight" in h:
            b = f"{prefix}.resblocks.{i}"
            blks.append({
                "ln_1": {"scale": _np(h[f"{b}.ln_1.weight"]), "bias": _np(h[f"{b}.ln_1.bias"])},
                "attn": {"qkv_w": _np(h[f"{b}.attn.in_proj_weight"]).T,
                         "qkv_b": _np(h[f"{b}.attn.in_proj_bias"]),
                         "out_w": _np(h[f"{b}.attn.out_proj.weight"]).T,
                         "out_b": _np(h[f"{b}.attn.out_proj.bias"])},
                "ln_2": {"scale": _np(h[f"{b}.ln_2.weight"]), "bias": _np(h[f"{b}.ln_2.bias"])},
                "mlp": {"fc_w": _np(h[f"{b}.mlp.c_fc.weight"]).T,
                        "fc_b": _np(h[f"{b}.mlp.c_fc.bias"]),
                        "proj_w": _np(h[f"{b}.mlp.c_proj.weight"]).T,
                        "proj_b": _np(h[f"{b}.mlp.c_proj.bias"])},
            })
            i += 1
        return _stack_trees(blks)

    def lct(prefix):
        ws, bs, j = [], [], 0
        while f"{prefix}.hashing.fc_list.{j}.weight" in h:
            ws.append(_np(h[f"{prefix}.hashing.fc_list.{j}.weight"])[0])
            bs.append(_np(h[f"{prefix}.hashing.fc_list.{j}.bias"])[0])
            j += 1
        return {"blocks": blocks(f"{prefix}.transformer"),
                "hashing": {"w": np.stack(ws), "b": np.stack(bs)}}

    return {"hash": {
        "gcl": {"mlp": res_mlps("gcl_i.mlp"),
                "concept": lin("gcl_i.common_concept_embedding", bias=False)},
        "lct_i": lct("lct_i"),
        "lct_t": lct("lct_t"),
        "img_concept_proj": lin("img_concept_proj"),
        "txt_concept_proj": lin("txt_concept_proj"),
    }}


_HEAD_IMPORTERS = {
    **{m: _heads_linear_family for m in LINEAR_FAMILY},
    "DNPH": _heads_dnph,
    "DPBE": _heads_dpbe,
    "DCHMT": _heads_dchmt,
    "TwDH": _heads_twdh,
    "MITH": _heads_mith,
}

# methods whose torch state dict also carries the port's aux state
_AUX_IMPORTERS = {"TwDH": _aux_twdh}


def import_reference_state_dict(sd: Dict[str, Any], method: str
                                ) -> Tuple[Params, ClipConfig, Params]:
    """The reference trainer's ``model.state_dict()`` -> (params, clip
    config, aux updates), numpy trees.  ``params`` has the layout of the
    Trainer's ``state.params`` for ``method`` ({"clip": ..., "img_head":
    ..., ...}); ``aux`` (possibly empty) holds the state-dict buffers the
    port keeps in ``state.aux`` (TwDH's BatchNorm statistics)."""
    importer = _HEAD_IMPORTERS.get(method)
    if importer is None:
        extra_modules = sorted({k.split(".")[0] for k in sd if not k.startswith("clip.")})
        raise NotImplementedError(
            f"importing reference {method} checkpoints is not supported: the model "
            f"carries method-specific modules {extra_modules} (model/{method}.py) with no "
            "one-to-one mapping; evaluate it with the reference code or retrain here")
    clip_sd = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
    if not clip_sd:
        raise ValueError("no clip.* keys: is this a trainer model-<epoch>.pth? (raw CLIP "
                         ".pt archives load through --clip-path, clip/convert.py)")
    clip_params, clip_cfg = convert_state_dict_numpy(clip_sd)
    aux = _AUX_IMPORTERS.get(method, lambda _: {})(sd)
    return {"clip": clip_params, **importer(sd)}, clip_cfg, aux


def import_reference_pth(path: str, method: str) -> Tuple[Params, ClipConfig, Params]:
    """Load a reference trainer ``model-<epoch>.pth`` from disk."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_reference_state_dict(sd, method)
