"""Hashing heads (port of ``ccmh/models/heads.py``).

Each head is an init function plus an apply function over a plain dict of
tensors in ``ccmh``'s layout (weights [in, out]).  LinearHash's training
dropout draws its mask from an explicit ``torch.Generator`` (``ccmh`` draws
it from a ``jax.random`` key: the same distribution, not the same bits).

Reference anchors:
  LinearHash — model/modelbase.py:25-35 (Linear + Dropout(0.2) + tanh)
  SelectHash — model/DCHMT.py:8-28 (fc->128, relu, K x Linear(128,2),
               softmax pairs; the "select" mechanism)
  PreLayer   — model/DNPH_TOMM.py:7-14 (label-logit predictor)
  ModalityHash — model/TwDH.py:60-90 (1-token MHA + norm + fc -> 2K,
               relu, softmax pairs)
  L2NormHash — model/DPBE.py:23-25 (Linear + L2 normalize, no tanh)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ccmh_torch.clip.model import layer_norm

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


# ---------------------------------------------------------------------------
# DNPH pre-layer (label-logit predictor)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (2 * torch.rand(shape, generator=gen, device=gen.device) - 1) * bound


def init_pre_layer(gen: torch.Generator, in_dim: int, n_class: int) -> Params:
    """torch Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(gen, (in_dim, n_class), bound),
            "b": _uniform(gen, (n_class,), bound)}


def pre_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# TwDH modality hash
# ---------------------------------------------------------------------------

def init_modality_hash(gen: torch.Generator, in_dim: int, out_dim: int,
                       layernorm: bool) -> Params:
    """nn.MultiheadAttention over a single token: softmax over one key is
    the identity, so attention reduces to out_proj(v_proj(x)); only the
    value path is kept (the same function)."""
    bound = 1.0 / math.sqrt(in_dim)
    dev = gen.device
    p: Params = {
        "v_w": _uniform(gen, (in_dim, in_dim), bound),
        "v_b": torch.zeros((in_dim,), device=dev),
        "out_w": _uniform(gen, (in_dim, in_dim), bound),
        "out_b": torch.zeros((in_dim,), device=dev),
        "fc2_w": _kaiming_uniform_fan_out(gen, in_dim, out_dim * 2),
        "fc2_b": torch.zeros((out_dim * 2,), device=dev),
    }
    norm = {"scale": torch.ones((in_dim,), device=dev), "bias": torch.zeros((in_dim,), device=dev)}
    p["ln" if layernorm else "bn"] = norm
    return p


def init_bn_state(in_dim: int, device=None) -> Params:
    return {"mean": torch.zeros((in_dim,), device=device),
            "var": torch.ones((in_dim,), device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def modality_hash(p: Params, x: torch.Tensor, *, train: bool = False,
                  bn_state: Optional[Params] = None, momentum: float = 0.1,
                  mask: Optional[torch.Tensor] = None):
    """[B, D] -> ([B, 2K] softmax-pair code, new_bn_state).

    The image head's BatchNorm in train mode normalises with the batch's
    biased variance and moves the running stats by the unbiased one;
    ``mask`` ([B] bool) restricts the statistics to the flagged rows (an
    eval loader's wrap-padded rows must not count)."""
    h = x @ p["v_w"] + p["v_b"]
    h = h @ p["out_w"] + p["out_b"]
    new_state = bn_state
    if "ln" in p:
        # the plain LayerNorm, as ccmh's head: not a tower block's kernel
        h = layer_norm(h, p["ln"]["scale"], p["ln"]["bias"])
    else:
        if train:
            if mask is not None:
                m = mask.to(h.dtype)[:, None]                            # [B, 1]
                n = torch.clamp(m.sum(), min=1.0)
                mean = (h * m).sum(0) / n
                var = (m * (h - mean) ** 2).sum(0) / n
            else:
                n = torch.tensor(float(h.shape[0]), device=h.device)
                mean = h.mean(0)
                var = ((h - mean) ** 2).mean(0)
            if bn_state is not None:
                unbiased = var * n / torch.clamp(n - 1, min=1.0)
                new_state = {
                    "mean": (1 - momentum) * bn_state["mean"] + momentum * mean,
                    "var": (1 - momentum) * bn_state["var"] + momentum * unbiased,
                    "count": bn_state["count"] + 1,
                }
        else:
            mean = bn_state["mean"] if bn_state is not None else torch.zeros_like(h[0])
            var = bn_state["var"] if bn_state is not None else torch.ones_like(h[0])
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        h = h * p["bn"]["scale"] + p["bn"]["bias"]
    h = torch.relu(h @ p["fc2_w"] + p["fc2_b"])
    pairs = torch.softmax(h.reshape(h.shape[0], -1, 2), dim=-1)
    return pairs.reshape(h.shape[0], -1), new_state


def softmax_pair_quantize(code_flat: torch.Tensor) -> torch.Tensor:
    """[B, 2K] continuous -> re-softmaxed pairs, flattened (model/TwDH.py:
    9-21 applied to long_hash @ trans)."""
    b = code_flat.shape[0]
    return torch.softmax(code_flat.reshape(b, -1, 2), dim=-1).reshape(b, -1)


def pair_code(code_flat: torch.Tensor) -> torch.Tensor:
    """[B, 2K] softmax pairs -> [B, K] ±1 int8 (the first maximum on a tie;
    train/TwDH/hash_train.py:165-177)."""
    b = code_flat.shape[0]
    return (2 * code_flat.reshape(b, -1, 2).argmax(dim=-1) - 1).to(torch.int8)


# ---------------------------------------------------------------------------
# DPBE L2-normalised linear head
# ---------------------------------------------------------------------------

def init_l2norm_hash(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(gen, (in_dim, out_dim), bound),
            "b": _uniform(gen, (out_dim,), bound)}
