"""DPSIH's DSIE module (AAAI'26): semantic information extraction from
token sequences into multi-embed codes.

Port of ``ccmh/models/dpsih.py`` (model/DPSIH.py:13-63): attention logits
``w2(tanh(w1(x)))`` over the tokens, a softmax over the token axis, E
pooled token summaries; a sigmoid-fc residual is added to the (broadcast)
hash code and LayerNormed -> [B, E, K] embeddings (E = num_embeds).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ccmh_torch.clip.model import layer_norm

Params = Dict[str, Any]


def _xavier(gen: torch.Generator, shape) -> torch.Tensor:
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (2 * torch.rand(shape, generator=gen, device=gen.device) - 1) * bound


def init_dsie(gen: torch.Generator, n_embeds: int, d_in: int, d_out: int, d_h: int) -> Params:
    dev = gen.device
    return {
        "w1": _xavier(gen, (d_in, d_h)),
        "w2": _xavier(gen, (d_h, n_embeds)),
        "fc": {"w": _xavier(gen, (d_in, d_out)), "b": torch.zeros((d_out,), device=dev)},
        "ln": {"scale": torch.ones((d_out,), device=dev), "bias": torch.zeros((d_out,), device=dev)},
    }


def dsie(p: Params, out: torch.Tensor, x: torch.Tensor,
         pad_mask: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """out: [B, K] hash code, x: [B, L, D] token states ->
    ([B, E, K] embeddings, [B, L, E] attention, [B, E, K] residual)."""
    attn = torch.tanh(x @ p["w1"]) @ p["w2"]               # [B, L, E]
    if pad_mask is not None:
        attn = attn.masked_fill(pad_mask[:, :, None], -math.inf)
    attn = torch.softmax(attn, dim=1)
    pooled = torch.einsum("ble,bld->bed", attn, x)         # [B, E, D]
    residual = torch.sigmoid(pooled @ p["fc"]["w"] + p["fc"]["b"])  # [B, E, K]
    merged = layer_norm(out[:, None, :].expand(residual.shape) + residual,
                        p["ln"]["scale"], p["ln"]["bias"])
    return merged, attn, residual


def l2norm(x: torch.Tensor) -> torch.Tensor:
    """model/DPSIH.py:8-10 (no epsilon, like the reference)."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True))
