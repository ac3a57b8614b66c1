"""MITH's hashing model (MM'23): token-level multi-granularity interaction.

Port of ``ccmh/models/mith.py`` (model/MITH.py:249-455), batch-first:

* GlobalConceptLearning — residual MLPs (exact-erf GELU, torch's
  ``nn.GELU``) + a bias-free concept embedding with tanh (:296-314); its
  weights are SHARED between the modalities (:413-414);
* LocalizedTokenAggregation — each token keeps its top-k concepts of the
  detached concept logits, a masked softmax over the token axis pools
  tokens into concepts (:317-376);
* a sin-cos positional encoding / sqrt(d) over the K concept tokens, a
  constant (:249-273);
* a pre-LN transformer over the K concept tokens: the towers' own
  :func:`ccmh_torch.clip.model.transformer` (CLIP's block, torch-default
  inits), so it runs the attention kernels (#1, #2) and, under
  ``set_ln_impl("fused")``, the LayerNorm kernels (#4, #5) at L = K;
* BitwiseHashing — K per-bit Linear(d -> 1) + tanh (:276-293).

The forward is split per modality (:func:`image_hash`, :func:`text_hash`)
so that serving encodes one tower alone; :func:`hashing_model` is the two
together, as ``ccmh``'s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ccmh_torch.clip.model import layer_norm, transformer
from ccmh_torch.config import MITHConfig
from ccmh_torch.ops.similarity import l2_normalize

Params = Dict[str, Any]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (2 * torch.rand(shape, generator=gen, device=gen.device) - 1) * bound


def _init_torch_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                       bias: bool = True) -> Params:
    """torch nn.Linear's default init (kaiming_uniform a=√5 and a bias
    U(±1/√in)), stored [in, out]."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (in_dim, out_dim), bound)}
    if bias:
        p["b"] = _uniform(gen, (out_dim,), bound)
    return p


def _init_torch_block(gen: torch.Generator, width: int) -> Params:
    """A residual attention block with torch's default module inits (the
    concept transformer is built from default-initialised torch modules,
    unlike the CLIP-initialised towers)."""
    dev = gen.device
    xav = math.sqrt(6.0 / (width + 3 * width))

    def ln():
        return {"scale": torch.ones((width,), device=dev), "bias": torch.zeros((width,), device=dev)}

    return {
        "ln_1": ln(),
        "attn": {
            "qkv_w": _uniform(gen, (width, 3 * width), xav),
            "qkv_b": torch.zeros((3 * width,), device=dev),
            "out_w": _init_torch_linear(gen, width, width, bias=False)["w"],
            "out_b": torch.zeros((width,), device=dev),
        },
        "ln_2": ln(),
        "mlp": {
            "fc_w": _init_torch_linear(gen, width, 4 * width, bias=False)["w"],
            "fc_b": _uniform(gen, (4 * width,), 1.0 / math.sqrt(width)),
            "proj_w": _init_torch_linear(gen, 4 * width, width, bias=False)["w"],
            "proj_b": _uniform(gen, (width,), 1.0 / math.sqrt(4 * width)),
        },
    }


def sincos_position(max_len: int, d_model: int) -> np.ndarray:
    """The sin-cos positional encoding / sqrt(d_model), [max_len, d_model]."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe / math.sqrt(d_model)


# ---------------------------------------------------------------------------
# sub-modules
# ---------------------------------------------------------------------------

def init_residual_mlps(gen: torch.Generator, dim: int, n_layers: int) -> Params:
    dev = gen.device
    return {"layers": [
        {"ln": {"scale": torch.ones((dim,), device=dev), "bias": torch.zeros((dim,), device=dev)},
         "fc1": _init_torch_linear(gen, dim, 4 * dim),
         "fc2": _init_torch_linear(gen, 4 * dim, dim)}
        for _ in range(n_layers)]}


def residual_mlps(p: Params, x: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    act = torch.nn.functional.gelu if activation == "gelu" else torch.relu   # exact erf GELU
    for layer in p["layers"]:
        h = layer_norm(x, layer["ln"]["scale"], layer["ln"]["bias"])
        h = act(h @ layer["fc1"]["w"] + layer["fc1"]["b"])
        x = x + (h @ layer["fc2"]["w"] + layer["fc2"]["b"])
    return x


def init_gcl(gen: torch.Generator, k_concept: int, dim: int, res_mlp_layers: int) -> Params:
    return {"mlp": init_residual_mlps(gen, dim, res_mlp_layers),
            "concept": _init_torch_linear(gen, dim, k_concept, bias=False)}


def gcl(p: Params, x: torch.Tensor, activation: str = "gelu"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GlobalConceptLearning -> (MLP features, tanh concept logits)."""
    h = residual_mlps(p["mlp"], x, activation)
    return h, torch.tanh(h @ p["concept"]["w"])


def localized_token_aggregation(tokens: torch.Tensor, concept: torch.Tensor, top_k: int,
                                key_padding_mask: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, L, D], concept [B, L, K] (detached by the caller),
    key_padding_mask [B, L] (True = pad) -> ([B, K, D] merged concept
    tokens, [B, L, K] pseudo labels)."""
    neg_inf = torch.full((), -math.inf, dtype=concept.dtype, device=concept.device)
    sim = concept
    if key_padding_mask is not None:
        sim = sim + torch.where(key_padding_mask.to(torch.bool), neg_inf,
                                torch.zeros_like(neg_inf))[:, :, None]
    sim = torch.where(sim > 0, sim, neg_inf)
    # each token keeps the concepts at or above its k-th largest value
    # (model/MITH.py:321-331): top-k *values*, not indices
    val_min = torch.topk(sim, top_k, dim=-1).values[..., -1:]
    sim = torch.where(sim >= val_min, sim, neg_inf)
    pseudo_label = (sim > 0).to(tokens.dtype)
    # softmax over the token axis per concept; an all -inf column is NaN -> 0
    w = torch.softmax(sim, dim=1)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    merged = torch.einsum("blk,bld->bkd", w, tokens)
    return merged, pseudo_label


def init_lct(gen: torch.Generator, dim: int, k_bits: int, n_layers: int) -> Params:
    blocks = [_init_torch_block(gen, dim) for _ in range(n_layers)]
    stack = lambda *xs: torch.stack(xs)                       # noqa: E731
    return {
        "blocks": _tree_map_n(stack, blocks),
        "hashing": {
            "w": torch.stack([_init_torch_linear(gen, dim, 1)["w"][:, 0]
                              for _ in range(k_bits)]),       # [K, D]
            "b": torch.zeros((k_bits,), device=gen.device),
        },
    }


def _tree_map_n(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map_n(fn, [t[k] for t in trees]) for k in first}
    return fn(*trees)


def lct(p: Params, tokens: torch.Tensor, concept: torch.Tensor, top_k: int, n_heads: int,
        key_padding_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LocalConceptTransforming -> (bit codes [B, K], pseudo labels,
    transformed concept tokens [B, K, D])."""
    x, pseudo = localized_token_aggregation(tokens, concept, top_k, key_padding_mask)
    # the sin-cos encoding is a constant (a registered buffer in the
    # reference, model/MITH.py:267), never a parameter
    pe = torch.from_numpy(sincos_position(x.shape[1], x.shape[2])).to(x.device, x.dtype)
    x, _ = transformer(x + pe[None], p["blocks"], n_heads)
    bits = torch.einsum("bkd,kd->bk", x, p["hashing"]["w"]) + p["hashing"]["b"]
    return torch.tanh(bits), pseudo, x


# ---------------------------------------------------------------------------
# the hashing model
# ---------------------------------------------------------------------------

class MithOutputs(NamedTuple):
    img_cls_hash: torch.Tensor
    txt_cls_hash: torch.Tensor
    res_img_cls: torch.Tensor
    res_txt_cls: torch.Tensor
    img_tokens_hash: torch.Tensor
    txt_tokens_hash: torch.Tensor
    trans_tokens_i: torch.Tensor
    trans_tokens_t: torch.Tensor


def init_hashing_model(gen: torch.Generator, dim: int, k_bits: int, mcfg: MITHConfig) -> Params:
    return {
        "gcl": init_gcl(gen, k_bits, dim, mcfg.res_mlp_layers),   # shared by both modalities
        "lct_i": init_lct(gen, dim, k_bits, mcfg.transformer_layers),
        "lct_t": init_lct(gen, dim, k_bits, mcfg.transformer_layers),
        "img_concept_proj": _init_torch_linear(gen, dim, dim),
        "txt_concept_proj": _init_torch_linear(gen, dim, dim),
    }


def _one_modality(p: Params, lct_key: str, proj_key: str, tokens: torch.Tensor,
                  cls: torch.Tensor, top_k: int, key_padding_mask=None):
    """-> (cls hash, l2-normalized cls residual, tokens hash, l2-normalized
    projected concept tokens) of one modality."""
    n_heads = tokens.shape[-1] // 64
    res_cls, cls_hash = gcl(p["gcl"], cls)
    concept = gcl(p["gcl"], tokens)[1].detach()
    tokens_hash, _, trans = lct(p[lct_key], tokens, concept, top_k=top_k, n_heads=n_heads,
                                key_padding_mask=key_padding_mask)
    proj = p[proj_key]
    return (cls_hash, l2_normalize(res_cls), tokens_hash,
            l2_normalize(trans @ proj["w"] + proj["b"]))


def image_hash(p: Params, img_tokens: torch.Tensor, img_cls: torch.Tensor, top_k: int = 8):
    """The image half: projected patch tokens [B, P, D] and the projected
    cls token [B, D] -> (cls hash, cls residual, tokens hash, concept tokens)."""
    return _one_modality(p, "lct_i", "img_concept_proj", img_tokens, img_cls, top_k)


def text_hash(p: Params, txt_tokens: torch.Tensor, txt_eos: torch.Tensor,
              key_padding_mask: torch.Tensor, top_k: int = 8):
    """The text half: projected tokens [B, L, D], the EOS token [B, D] and
    the key-padding mask (pads and EOT masked)."""
    return _one_modality(p, "lct_t", "txt_concept_proj", txt_tokens, txt_eos, top_k,
                         key_padding_mask)


def hashing_model(p: Params, img_tokens: torch.Tensor, txt_tokens: torch.Tensor,
                  img_cls: torch.Tensor, txt_eos: torch.Tensor,
                  key_padding_mask: torch.Tensor, top_k: int = 8) -> MithOutputs:
    ic, ir, it, ip = image_hash(p, img_tokens, img_cls, top_k)
    tc, tr, tt, tp = text_hash(p, txt_tokens, txt_eos, key_padding_mask, top_k)
    return MithOutputs(img_cls_hash=ic, txt_cls_hash=tc, res_img_cls=ir, res_txt_cls=tr,
                       img_tokens_hash=it, txt_tokens_hash=tt, trans_tokens_i=ip,
                       trans_tokens_t=tp)
