"""Hashing heads (port of the DCHMT and LinearHash heads of
``ccmh/models/heads.py``).

Each head is an init function plus an apply function over a plain dict of
tensors in ``ccmh``'s layout (weights [in, out]).  LinearHash's training
dropout draws its mask from an explicit ``torch.Generator`` (``ccmh`` draws
it from a ``jax.random`` key: the same distribution, not the same bits).

Reference anchors:
  LinearHash — model/modelbase.py:25-35 (Linear + Dropout(0.2) + tanh)
  SelectHash — model/DCHMT.py:8-28 (fc->128, relu, K x Linear(128,2),
               softmax pairs; the "select" mechanism)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


def _kaiming_uniform_fan_out(gen: torch.Generator, in_dim: int, out_dim: int) -> torch.Tensor:
    """weights_init_kaiming (model/modelbase.py:11-14): kaiming_uniform with
    mode='fan_out', gain sqrt(2) => U(-sqrt(6/out), sqrt(6/out)), stored
    [in, out]."""
    bound = math.sqrt(6.0 / out_dim)
    u = torch.rand((in_dim, out_dim), generator=gen, device=gen.device)
    return (2 * u - 1) * bound


# ---------------------------------------------------------------------------
# LinearHash
# ---------------------------------------------------------------------------

def init_linear_hash(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    return {"w": _kaiming_uniform_fan_out(gen, in_dim, out_dim),
            "b": torch.zeros((out_dim,), device=gen.device)}


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             train: bool) -> torch.Tensor:
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def linear_hash(p: Params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                drop_rate: float = 0.2) -> torch.Tensor:
    """tanh(dropout(x @ w + b)); dropout precedes tanh as in the reference
    and runs only with ``train=True`` and a generator."""
    return torch.tanh(_dropout(x @ p["w"] + p["b"], drop_rate, generator, train))


# ---------------------------------------------------------------------------
# DCHMT select hash
# ---------------------------------------------------------------------------

SELECT_EMBED = 128  # model/DCHMT.py:10 LINEAR_EMBED


def init_select_hash(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    # K independent Linear(128 -> 2) == one Linear(128 -> 2K) on a reshaped
    # output, kept fused as [128, K, 2]
    return {
        "fc_w": _kaiming_uniform_fan_out(gen, in_dim, SELECT_EMBED),
        "fc_b": torch.zeros((SELECT_EMBED,), device=gen.device),
        "pairs_w": _kaiming_uniform_fan_out(gen, SELECT_EMBED, 2 * out_dim)
        .reshape(SELECT_EMBED, out_dim, 2),
        "pairs_b": torch.zeros((out_dim, 2), device=gen.device),
    }


def select_hash(p: Params, x: torch.Tensor) -> torch.Tensor:
    """-> [B, K, 2] softmax pair distributions ("select" mechanism)."""
    h = torch.relu(x @ p["fc_w"] + p["fc_b"])
    logits = torch.einsum("be,ekt->bkt", h, p["pairs_w"]) + p["pairs_b"]
    return torch.softmax(logits, dim=-1)


def select_code(pairs: torch.Tensor) -> torch.Tensor:
    """[B, K, 2] -> ±1 int8 codes: argmax per pair (the first maximum on a
    tie), 0 -> -1 (train/base.py:150-158 make_hash_code_DCHMT)."""
    return (2 * pairs.argmax(dim=-1) - 1).to(torch.int8)
