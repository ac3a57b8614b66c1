"""Export the port's parameters to a reference-format ``model-<epoch>.pth``
(port of ``ccmh/clip/export_ref.py``).

The inverse of :mod:`ccmh_torch.clip.import_ref`: a parameter tree (and,
where the torch state dict carries buffers, the matching ``aux`` entries)
becomes the flat ``model.state_dict()`` the reference trainer saves every
epoch (train/base.py:225-227), which its ``--pretrained`` loads
(train/DSPH/hash_train.py:30-32).  The methods are import_ref's.  Two
reconstructions keep the function exact:

* TwDH's one-token attention (model/TwDH.py:55-84): softmax over one key
  is 1, so its q/k projections cannot reach the output and the port keeps
  none; they are written as zeros.  The dead LinearHash heads that MTwDH
  never removes (model/TwDH.py:108) are written as zeros too, so a strict
  load succeeds.
* MITH's sin-cos positional-encoding buffer is recomputed, and the shared
  GCL is written under both of its upstream names (``gcl_i``, ``gcl_t``).

Only ViT towers export.

CLI (through ``Retriever.from_pretrained``, so any checkpoint it reads)::

    python -m ccmh_torch.clip.export_ref <ckpt: .npz | .pth | state dir> \
        --method DSPH --output-dim 64 [--clip-path tower] -o model.pth [--device cuda]
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ccmh_torch.clip.import_ref import LINEAR_FAMILY
from ccmh_torch.models.mith import sincos_position

Params = Dict[str, Any]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _linear(out: Dict[str, np.ndarray], prefix: str, p: Params) -> None:
    """{w: [in, out], b: [out]} -> torch nn.Linear keys."""
    out[f"{prefix}.weight"] = _np(p["w"]).T.copy()
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _ln(out: Dict[str, np.ndarray], prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _export_blocks(out: Dict[str, np.ndarray], prefix: str, blocks: Params) -> None:
    """Stacked [L, ...] block parameters -> per-layer torch resblock keys."""
    blocks = {name: {k: _np(v) for k, v in group.items()} for name, group in blocks.items()}
    for i in range(blocks["ln_1"]["scale"].shape[0]):
        b = f"{prefix}.resblocks.{i}"
        _ln(out, f"{b}.ln_1", {k: v[i] for k, v in blocks["ln_1"].items()})
        attn = blocks["attn"]
        out[f"{b}.attn.in_proj_weight"] = attn["qkv_w"][i].T.copy()
        out[f"{b}.attn.in_proj_bias"] = attn["qkv_b"][i]
        out[f"{b}.attn.out_proj.weight"] = attn["out_w"][i].T.copy()
        out[f"{b}.attn.out_proj.bias"] = attn["out_b"][i]
        _ln(out, f"{b}.ln_2", {k: v[i] for k, v in blocks["ln_2"].items()})
        mlp = blocks["mlp"]
        out[f"{b}.mlp.c_fc.weight"] = mlp["fc_w"][i].T.copy()
        out[f"{b}.mlp.c_fc.bias"] = mlp["fc_b"][i]
        out[f"{b}.mlp.c_proj.weight"] = mlp["proj_w"][i].T.copy()
        out[f"{b}.mlp.c_proj.bias"] = mlp["proj_b"][i]


def export_clip_state_dict(clip_params: Params, prefix: str = "clip.") -> Dict[str, np.ndarray]:
    """The port's CLIP tree -> the reference's CLIP state-dict keys
    (model/base/model.py:415-455), each under ``prefix``; with ``prefix=""``
    the OpenAI ``.pt`` layout that ``--clip-path`` reads."""
    v = clip_params["visual"]
    if "stem" in v:
        raise NotImplementedError("RN-family CLIP export is not supported: no reference "
                                  "method ships a ResNet checkpoint (argsbase.py:32)")
    out: Dict[str, np.ndarray] = {}
    patch_w = _np(v["patch_w"])                     # [(ph, pw, c), W]
    width = patch_w.shape[1]
    patch = int(round((patch_w.shape[0] // 3) ** 0.5))
    # [Ph*Pw*C, W] -> [Ph, Pw, C, W] -> [W, C, Ph, Pw]
    out[f"{prefix}visual.conv1.weight"] = (
        patch_w.reshape(patch, patch, 3, width).transpose(3, 2, 0, 1).copy())
    out[f"{prefix}visual.class_embedding"] = _np(v["class_embedding"])
    out[f"{prefix}visual.positional_embedding"] = _np(v["positional_embedding"])
    _ln(out, f"{prefix}visual.ln_pre", v["ln_pre"])
    _export_blocks(out, f"{prefix}visual.transformer", v["blocks"])
    _ln(out, f"{prefix}visual.ln_post", v["ln_post"])
    out[f"{prefix}visual.proj"] = _np(v["proj"])

    t = clip_params["text"]
    out[f"{prefix}token_embedding.weight"] = _np(t["token_embedding"])
    out[f"{prefix}positional_embedding"] = _np(t["positional_embedding"])
    _export_blocks(out, f"{prefix}transformer", t["blocks"])
    _ln(out, f"{prefix}ln_final", t["ln_final"])
    out[f"{prefix}text_projection"] = _np(t["text_projection"])
    out[f"{prefix}logit_scale"] = _np(clip_params["logit_scale"])
    return out


def _heads_linear_family(params: Params, aux: Params) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _linear(out, "image_hash.fc", params["img_head"])
    _linear(out, "text_hash.fc", params["txt_head"])
    return out


def _heads_dnph(params: Params, aux: Params) -> Dict[str, np.ndarray]:
    out = _heads_linear_family(params, aux)
    _linear(out, "image_pre.fc", params["img_pre"])
    _linear(out, "text_pre.fc", params["txt_pre"])
    return out


def _heads_dpbe(params: Params, aux: Params) -> Dict[str, np.ndarray]:
    # Sequential(Linear, L2Norm) -> module key "image_hash.0" (model/DPBE.py:23-25)
    out: Dict[str, np.ndarray] = {}
    _linear(out, "image_hash.0", params["img_head"])
    _linear(out, "text_hash.0", params["txt_head"])
    return out


def _select_hash(out: Dict[str, np.ndarray], module: str, p: Params) -> None:
    """The select-hash layout -> DCHMT's HashLayer (model/DCHMT.py:8-28)."""
    out[f"{module}.fc.weight"] = _np(p["fc_w"]).T.copy()
    out[f"{module}.fc.bias"] = _np(p["fc_b"])
    pairs_w = _np(p["pairs_w"])                     # [128, K, 2]
    pairs_b = _np(p["pairs_b"])                     # [K, 2]
    for i in range(pairs_w.shape[1]):
        out[f"{module}.hash_list.{i}.weight"] = pairs_w[:, i, :].T.copy()
        out[f"{module}.hash_list.{i}.bias"] = pairs_b[i]


def _heads_dchmt(params: Params, aux: Params) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _select_hash(out, "image_hash", params["img_head"])
    _select_hash(out, "text_hash", params["txt_head"])
    return out


def _modality_hash(out: Dict[str, np.ndarray], prefix: str, p: Params,
                   bn_state: Optional[Params]) -> None:
    """A TwDH head -> ModalityHash (model/TwDH.py:55-84), its q/k rows zero."""
    v_w = _np(p["v_w"])
    e = v_w.shape[0]
    in_proj_w = np.zeros((3 * e, e), np.float32)
    in_proj_b = np.zeros((3 * e,), np.float32)
    in_proj_w[2 * e:] = v_w.T
    in_proj_b[2 * e:] = _np(p["v_b"])
    out[f"{prefix}.atten.in_proj_weight"] = in_proj_w
    out[f"{prefix}.atten.in_proj_bias"] = in_proj_b
    out[f"{prefix}.atten.out_proj.weight"] = _np(p["out_w"]).T.copy()
    out[f"{prefix}.atten.out_proj.bias"] = _np(p["out_b"])
    out[f"{prefix}.fc2.weight"] = _np(p["fc2_w"]).T.copy()
    out[f"{prefix}.fc2.bias"] = _np(p["fc2_b"])
    _ln(out, f"{prefix}.norm", p["ln"] if "ln" in p else p["bn"])
    if "bn" in p:
        if bn_state is None:
            raise ValueError("TwDH export needs the BatchNorm statistics: pass "
                             "aux={'bn': state.aux['bn']}")
        out[f"{prefix}.norm.running_mean"] = _np(bn_state["mean"])
        out[f"{prefix}.norm.running_var"] = _np(bn_state["var"])
        out[f"{prefix}.norm.num_batches_tracked"] = np.asarray(int(_np(bn_state["count"])),
                                                               np.int64)


def _heads_twdh(params: Params, aux: Params) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _modality_hash(out, "img_hash", params["img_head"], aux.get("bn"))
    _modality_hash(out, "txt_hash", params["txt_head"], None)
    # MTwDH keeps Baseclip's LinearHash heads, unused (model/TwDH.py:108 vs
    # modelbase.py:57-58): zeros, so a strict load finds them
    e = _np(params["img_head"]["v_w"]).shape[0]
    k_long = _np(params["img_head"]["fc2_w"]).shape[1] // 2
    for dead in ("image_hash", "text_hash"):
        out[f"{dead}.fc.weight"] = np.zeros((k_long, e), np.float32)
        out[f"{dead}.fc.bias"] = np.zeros((k_long,), np.float32)
    return out


def _heads_mith(params: Params, aux: Params) -> Dict[str, np.ndarray]:
    """models/mith.py's tree -> HashingModel's state dict
    (model/MITH.py:217-454), the shared GCL under both of its names."""
    h = params["hash"]
    out: Dict[str, np.ndarray] = {}
    gcl: Dict[str, np.ndarray] = {}
    layers = h["gcl"]["mlp"]["layers"]
    if isinstance(layers, dict):                    # stacked residual MLPs
        n = _np(layers["ln"]["scale"]).shape[0]
        layers = [{k1: {k2: v2[i] for k2, v2 in v1.items()} for k1, v1 in layers.items()}
                  for i in range(n)]
    for i, layer in enumerate(layers):
        _ln(gcl, f"mlp.lns.{i}", layer["ln"])
        _linear(gcl, f"mlp.mlps.{i}.0", layer["fc1"])
        _linear(gcl, f"mlp.mlps.{i}.3", layer["fc2"])
    _linear(gcl, "common_concept_embedding", h["gcl"]["concept"])
    for alias in ("gcl_i", "gcl_t"):
        out.update({f"hash.{alias}.{k}": v for k, v in gcl.items()})
    for name in ("lct_i", "lct_t"):
        lct = h[name]
        _export_blocks(out, f"hash.{name}.transformer", lct["blocks"])
        ws, bs = _np(lct["hashing"]["w"]), _np(lct["hashing"]["b"])
        for j in range(ws.shape[0]):
            out[f"hash.{name}.hashing.fc_list.{j}.weight"] = ws[j][None, :].copy()
            out[f"hash.{name}.hashing.fc_list.{j}.bias"] = bs[j][None].copy()
        # the PositionalEncoding buffer (model/MITH.py:255-268), [K, 1, D]
        out[f"hash.{name}.position.pe"] = sincos_position(ws.shape[0], ws.shape[1])[:, None, :]
    _linear(out, "hash.img_concept_proj", h["img_concept_proj"])
    _linear(out, "hash.txt_concept_proj", h["txt_concept_proj"])
    return out


_HEAD_EXPORTERS = {
    **{m: _heads_linear_family for m in LINEAR_FAMILY},
    "DNPH": _heads_dnph,
    "DPBE": _heads_dpbe,
    "DCHMT": _heads_dchmt,
    "TwDH": _heads_twdh,
    "MITH": _heads_mith,
}


def export_reference_state_dict(params: Params, method: str, aux: Optional[Params] = None
                                ) -> Dict[str, np.ndarray]:
    """``state.params`` (+ ``state.aux`` where torch keeps buffers in the
    state dict: TwDH's BatchNorm statistics) -> the reference trainer's
    ``model.state_dict()`` as float32 numpy arrays (the step counter
    int64)."""
    exporter = _HEAD_EXPORTERS.get(method)
    if exporter is None:
        raise NotImplementedError(
            f"exporting {method} to a reference checkpoint is not supported: the reference "
            "model does not run as committed (see clip/import_ref.py), so no reference "
            "code can load it")
    out = export_clip_state_dict(params["clip"])
    out.update(exporter(params, aux or {}))
    return out


def export_reference_pth(path: str, params: Params, method: str,
                         aux: Optional[Params] = None) -> None:
    """``torch.save`` a reference-loadable ``model-<epoch>.pth``."""
    import torch

    sd = export_reference_state_dict(params, method, aux)
    # np.array, not np.ascontiguousarray (ccmh's), which makes the 0-d
    # logit_scale and num_batches_tracked [1]: a strict load refuses those
    torch.save({k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}, path)


def main(argv=None) -> int:
    import argparse

    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever

    ap = argparse.ArgumentParser(description="Export a checkpoint to a reference model-<e>.pth")
    ap.add_argument("ckpt", help=".npz / full-state directory / (round-trip) .pth")
    ap.add_argument("--method", required=True)
    ap.add_argument("--output-dim", type=int, default=64)
    ap.add_argument("--nclass", type=int, default=24)
    ap.add_argument("--clip-path", default="",
                    help="CLIP checkpoint that defines the tower architecture (only its "
                         "shapes matter; the weights come from ckpt)")
    ap.add_argument("-o", "--out", default="model-export.pth")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config(method=args.method, output_dim=args.output_dim, nclass=args.nclass,
                 clip_path=args.clip_path, pretrained=args.ckpt)
    r = Retriever.from_pretrained(cfg, device=args.device)
    export_reference_pth(args.out, r.params, args.method, r.aux)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
