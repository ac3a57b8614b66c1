"""CLIP towers (ViT vision tower + causal text transformer) in PyTorch.

Port of ``ccmh/clip/model.py`` as plain functions on a parameter tree of
tensors, in ``ccmh``'s own layout so that weights cross between the two
packages unchanged (``ccmh_torch/bridge.py``):

* weights are stored [in, out] (``y = x @ w + b``); the transformer blocks
  are stacked, each leaf with a leading layer axis, and run as a loop over
  the layers;
* the patchify "conv" is a reshape + one matmul with the [p*p*3, W]
  ``patch_w`` (flattening order (ph, pw, channel));
* batch-first [B, L, D] layout; LayerNorm and softmax compute in fp32
  whatever the compute dtype.

Attention dispatch follows ``ccmh``: the fused kernel
(ccmh_torch/ops/attention.py) whenever the attention weights are not asked
for and the mask is None or [L, L]; a per-example key-padding bias
[B, 1, L, L] and ``need_weights`` take the plain formulation.  The
blocks' LayerNorms take the fused kernels (ccmh_torch/ops/layernorm.py)
under ``set_ln_impl("fused")``; ``ln_pre``, ``ln_post`` and ``ln_final``
stay plain, as in ``ccmh``.

The towers return ``ccmh``'s :class:`VisionOutput` / :class:`TextOutput`:
``features="pooled"`` the CLIP embedding, ``"tokens"`` also the
pre-projection token states (DPSIH), ``"mith"`` every token through the
final LayerNorm and the projection, the last layer's attention row of the
cls (vision) or EOS (text) token and the extended key-padding mask (MITH).
The head-major (tensor-parallel) layout is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ccmh_torch.ops.attention import attention_reference, fused_attention
from ccmh_torch.ops.layernorm import (
    fused_add_layer_norm, fused_layer_norm, layer_norm_reference,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """Architecture hyperparameters (ViT-B/32 defaults)."""

    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid

    @classmethod
    def tiny(cls) -> "ClipConfig":
        """Small config for tests: full architecture, toy sizes."""
        return cls(
            embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=16, context_length=77, vocab_size=49408,
            transformer_width=128, transformer_heads=2, transformer_layers=2,
        )


class VisionOutput(NamedTuple):
    pooled: torch.Tensor                       # [B, E] CLIP embedding
    tokens_pre: Optional[torch.Tensor] = None  # [B, 1+P, W] after the blocks
    tokens_proj: Optional[torch.Tensor] = None  # [B, 1+P, E] ln_post(all) @ proj
    cls_attn: Optional[torch.Tensor] = None    # [B, P] last layer's cls -> patch row


class TextOutput(NamedTuple):
    pooled: torch.Tensor                       # [B, E] EOT-pooled embedding
    tokens_pre: Optional[torch.Tensor] = None  # [B, L, W] after the blocks
    tokens_proj: Optional[torch.Tensor] = None  # [B, L, E] ln_final(all) @ projection
    eos_attn: Optional[torch.Tensor] = None    # [B, L] last layer's EOS row
    key_padding_mask: Optional[torch.Tensor] = None  # [B, L] pads *and* EOT


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

# fp32-stable LayerNorm (biased variance); casts back to the input dtype
layer_norm = layer_norm_reference


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# "fused" = the CUDA attention kernel (its plain version on CPU tensors),
# "plain" = the plain formulation everywhere, also on the card (the
# baseline the kernel path is held against).
ATTN_IMPL = "fused"

# LayerNorm of the transformer blocks: "fused" = kernel #4 for ln_1 and
# kernel #5 for the residual add + ln_2 (ccmh_torch/ops/layernorm.py, their
# plain versions on CPU tensors), "plain" = the plain formulation.  The
# default is "plain", as ccmh's is "xla": ccmh measured its fused LN as a
# net loss on a TPU's encode path, and the H100 A/B is in PERF.md.
LN_IMPL = "plain"


def set_attn_impl(impl: str) -> None:
    global ATTN_IMPL
    if impl not in ("fused", "plain"):
        raise ValueError(f"attention impl must be 'fused' or 'plain', got {impl!r}")
    ATTN_IMPL = impl


def set_ln_impl(impl: str) -> None:
    global LN_IMPL
    if impl not in ("fused", "plain"):
        raise ValueError(f"LayerNorm impl must be 'fused' or 'plain', got {impl!r}")
    LN_IMPL = impl


def multi_head_attention(x: torch.Tensor, p: Params, n_head: int,
                         attn_bias: Optional[torch.Tensor] = None,
                         need_weights: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Self-attention over [B, L, D] with a fused qkv projection ->
    (output, weights or None).

    ``attn_bias`` is an additive fp32 [L, L] or [B, 1, L, L] mask (0 /
    -inf) or None.  The weights, with ``need_weights``, are the softmax
    probabilities averaged over heads [B, L, L] (torch MHA's, which MITH
    reads)."""
    if ATTN_IMPL == "fused" and not need_weights and (attn_bias is None or attn_bias.ndim == 2):
        # feed the RAW x @ qkv_w product; the kernel folds qkv_b into its
        # load, saving the [B, L, 3D] round trip of a standalone bias add
        ctx = fused_attention(x @ p["qkv_w"], attn_bias, n_head, qkv_b=p["qkv_b"])
        weights = None
    elif need_weights:
        ctx, weights = attention_reference(x @ p["qkv_w"] + p["qkv_b"], attn_bias, n_head,
                                           need_weights=True)
    else:
        ctx, weights = attention_reference(x @ p["qkv_w"] + p["qkv_b"], attn_bias, n_head), None
    return ctx @ p["out_w"] + p["out_b"], weights


def _block(x: torch.Tensor, p: Params, n_head: int, attn_bias: Optional[torch.Tensor],
           need_weights: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN residual attention block (attention + QuickGELU MLP) ->
    (output, the attention weights with ``need_weights``)."""
    fused = LN_IMPL == "fused"
    ln = fused_layer_norm if fused else layer_norm
    h = ln(x, p["ln_1"]["scale"], p["ln_1"]["bias"])
    attn_out, weights = multi_head_attention(h, p["attn"], n_head, attn_bias, need_weights)
    if fused:
        # the residual add + pre-MLP LN in one pass (kernel #5)
        h, x = fused_add_layer_norm(x, attn_out, p["ln_2"]["scale"], p["ln_2"]["bias"])
    else:
        x = x + attn_out
        h = layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"])
    mlp = p["mlp"]
    x = x + (quick_gelu(h @ mlp["fc_w"] + mlp["fc_b"]) @ mlp["proj_w"] + mlp["proj_b"])
    return x, weights


def _layer(tree: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def transformer(x: torch.Tensor, stacked: Params, n_head: int,
                attn_bias: Optional[torch.Tensor] = None, need_last_attn: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the blocks in order over the stacked layer parameters ->
    (output, the last block's attention weights with ``need_last_attn``;
    only that block then takes the plain attention, as in ``ccmh``).

    Weights in another dtype than ``x`` are cast per layer (LayerNorm still
    reduces in fp32); :func:`cast_clip_params` casts them once instead."""
    n_layers = stacked["ln_1"]["scale"].shape[0]
    weights = None
    for i in range(n_layers):
        layer = _layer(stacked, i)
        if layer["ln_1"]["scale"].dtype != x.dtype:
            layer = _map(lambda t: t.to(x.dtype), layer)
        x, weights = _block(x, layer, n_head, attn_bias,
                            need_weights=need_last_attn and i == n_layers - 1)
    return x, weights


def _map(fn, tree: Params) -> Params:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def cast_clip_params(clip: Params, dtype: torch.dtype) -> Params:
    """The CLIP tree with every weight the towers use in ``dtype`` cast once
    (a bf16 server then reads bf16 weights instead of casting per call).
    ``ln_pre``, ``ln_post``, ``ln_final`` and ``logit_scale`` stay as they
    are: the towers read them in fp32, as ``ccmh`` does."""
    keep = ("ln_pre", "ln_post", "ln_final", "logit_scale")

    def cast(tree: Params) -> Params:
        return {k: (v if k in keep else cast(v) if isinstance(v, dict)
                    else v.to(dtype)) for k, v in tree.items()}

    return cast(clip)


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

# CLIP pixel normalization constants (dataset/base.py:39 of the reference)
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_pixels(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> CLIP-normalized float32 (/255, -mean, /std)."""
    x = images.float() / 255.0
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=torch.float32, device=images.device)
    return (x - mean) / std


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, (H/p)*(W/p), p*p*3] non-overlapping patches,
    flattened in (ph, pw, channel) order (conv(x, w) == patchify(x) @ flat(w))."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def vision_forward(p: Params, cfg: ClipConfig, images: torch.Tensor, *,
                   dtype: torch.dtype = torch.float32,
                   features: str = "pooled") -> VisionOutput:
    """ViT forward (reference model/base/model.py:228-252).  ``features``:

    "pooled": the CLIP embedding;
    "tokens": and the token states before ``ln_post`` (DPSIH,
              model/DPSIH.py:88-95);
    "mith":   ``ln_post`` on *all* tokens, all projected, and the last
              layer's cls -> patch attention row (model/MITH.py:57-83)."""
    if features not in ("pooled", "tokens", "mith"):
        raise ValueError(f"features must be 'pooled', 'tokens' or 'mith', got {features!r}")
    if images.dtype == torch.uint8:
        images = normalize_pixels(images)
    x = patchify(images.to(dtype), cfg.vision_patch_size)
    x = x @ p["patch_w"].to(dtype)                         # [B, P, W]
    B = x.shape[0]
    cls = p["class_embedding"].to(dtype).expand(B, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + p["positional_embedding"].to(dtype)
    x = layer_norm(x, p["ln_pre"]["scale"], p["ln_pre"]["bias"])
    x, attn = transformer(x, p["blocks"], cfg.vision_heads, None,
                          need_last_attn=features == "mith")
    if features == "mith":
        h = layer_norm(x, p["ln_post"]["scale"], p["ln_post"]["bias"])
        tokens_proj = h @ p["proj"].to(dtype)              # [B, 1+P, E]
        return VisionOutput(pooled=tokens_proj[:, 0, :], tokens_pre=x,
                            tokens_proj=tokens_proj, cls_attn=attn[:, 0, 1:])
    pooled = layer_norm(x[:, 0, :], p["ln_post"]["scale"], p["ln_post"]["bias"])
    pooled = pooled @ p["proj"].to(dtype)
    return VisionOutput(pooled=pooled, tokens_pre=x if features == "tokens" else None)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------

def causal_mask(length: int, device: Any = "cpu") -> torch.Tensor:
    """Additive [L, L] causal bias (0 on/below diagonal, -inf above)."""
    keep = torch.ones((length, length), dtype=torch.bool, device=device).tril()
    return torch.zeros((length, length), device=device).masked_fill(~keep, -math.inf)


def text_forward(p: Params, cfg: ClipConfig, ids: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32, features: str = "pooled",
                 key_padding_mask: Optional[torch.Tensor] = None) -> TextOutput:
    """Causal text transformer with EOT pooling.

    ``ids``: integer [B, L] (L <= context_length; the positional embedding
    is sliced to L).  The EOT position is ``argmax(ids)`` (the EOT id is
    the largest in the vocab; the first maximum wins, as in ``ccmh``).
    ``key_padding_mask`` [B, L] (True = a masked key, torch's convention)
    joins the causal mask as a per-example [B, 1, L, L] bias.
    ``features``: "pooled" | "tokens" | "mith" (every token projected, the
    EOS attention row with its own column zeroed and the key-padding mask
    extended to the EOT token, model/MITH.py:120-144)."""
    if features not in ("pooled", "tokens", "mith"):
        raise ValueError(f"features must be 'pooled', 'tokens' or 'mith', got {features!r}")
    B, L = ids.shape
    ids = ids.long()
    x = p["token_embedding"].to(dtype)[ids]               # [B, L, W]
    x = x + p["positional_embedding"].to(dtype)[:L]
    bias = causal_mask(L, device=x.device)
    if key_padding_mask is not None:
        kp = torch.zeros(key_padding_mask.shape, device=x.device).masked_fill(
            key_padding_mask.to(torch.bool), -math.inf)
        bias = bias[None, None, :, :] + kp[:, None, None, :]
    x, attn = transformer(x, p["blocks"], cfg.transformer_heads, bias,
                          need_last_attn=features == "mith")
    eos_pos = ids.argmax(dim=-1)                           # [B]
    rows = torch.arange(B, device=x.device)
    h = layer_norm(x, p["ln_final"]["scale"], p["ln_final"]["bias"])
    if features == "mith":
        tokens_proj = h @ p["text_projection"].to(dtype)   # [B, L, E]
        eos_attn = attn[rows, eos_pos]                     # [B, L]
        eos_attn = eos_attn * (1.0 - torch.nn.functional.one_hot(eos_pos, L).to(eos_attn.dtype))
        kpm = (key_padding_mask.to(torch.bool) if key_padding_mask is not None
               else torch.zeros((B, L), dtype=torch.bool, device=x.device))
        return TextOutput(pooled=tokens_proj[rows, eos_pos], tokens_pre=x,
                          tokens_proj=tokens_proj, eos_attn=eos_attn,
                          key_padding_mask=kpm | (ids == cfg.vocab_size - 1))
    pooled = h[rows, eos_pos] @ p["text_projection"].to(dtype)
    return TextOutput(pooled=pooled, tokens_pre=x if features == "tokens" else None)


# ---------------------------------------------------------------------------
# initialization (distributional parity with model/base/model.py:311-338)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return std * torch.randn(shape, generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (2 * torch.rand(shape, generator=gen, device=gen.device) - 1) * bound


def _init_ln(width: int, n: int, device) -> Params:
    return {"scale": torch.ones((n, width), device=device),
            "bias": torch.zeros((n, width), device=device)}


def _init_blocks(gen: torch.Generator, n: int, width: int, attn_std: float,
                 proj_std: float, fc_std: float) -> Params:
    dev = gen.device
    return {
        "ln_1": _init_ln(width, n, dev),
        "attn": {
            "qkv_w": _normal(gen, (n, width, 3 * width), attn_std),
            "qkv_b": torch.zeros((n, 3 * width), device=dev),
            "out_w": _normal(gen, (n, width, width), proj_std),
            "out_b": torch.zeros((n, width), device=dev),
        },
        "ln_2": _init_ln(width, n, dev),
        "mlp": {
            "fc_w": _normal(gen, (n, width, 4 * width), fc_std),
            "fc_b": torch.zeros((n, 4 * width), device=dev),
            "proj_w": _normal(gen, (n, 4 * width, width), proj_std),
            "proj_b": torch.zeros((n, width), device=dev),
        },
    }


def init_clip_params(gen: torch.Generator, cfg: ClipConfig = ClipConfig()) -> Params:
    """Random CLIP parameters in ``ccmh``'s layout, drawn from ``gen`` on
    ``gen.device`` (same distributions as ``ccmh``'s init; not the same
    numbers — torch and JAX generators differ)."""
    vw, tw = cfg.vision_width, cfg.transformer_width
    dev = gen.device
    v_scale = vw ** -0.5
    patch_fan_in = 3 * cfg.vision_patch_size ** 2
    patch_bound = (1.0 / patch_fan_in) ** 0.5 * math.sqrt(3.0)
    v_proj_std = (vw ** -0.5) * ((2 * cfg.vision_layers) ** -0.5)
    t_proj_std = (tw ** -0.5) * ((2 * cfg.transformer_layers) ** -0.5)
    ln = lambda w: {"scale": torch.ones((w,), device=dev),  # noqa: E731
                    "bias": torch.zeros((w,), device=dev)}
    visual = {
        "patch_w": _uniform(gen, (patch_fan_in, vw), patch_bound),
        "class_embedding": _normal(gen, (vw,), v_scale),
        "positional_embedding": _normal(gen, (cfg.n_patches + 1, vw), v_scale),
        "ln_pre": ln(vw),
        "blocks": _init_blocks(gen, cfg.vision_layers, vw, vw ** -0.5,
                               v_proj_std, (2 * vw) ** -0.5),
        "ln_post": ln(vw),
        "proj": _normal(gen, (vw, cfg.embed_dim), v_scale),
    }
    text = {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02),
        "positional_embedding": _normal(gen, (cfg.context_length, tw), 0.01),
        "blocks": _init_blocks(gen, cfg.transformer_layers, tw, tw ** -0.5,
                               t_proj_std, (2 * tw) ** -0.5),
        "ln_final": ln(tw),
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5),
    }
    return {"visual": visual, "text": text,
            "logit_scale": torch.tensor(math.log(1.0 / 0.07), device=dev)}
