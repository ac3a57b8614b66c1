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
(ccmh_torch/ops/attention.py) whenever the mask is None or [L, L].  The
blocks' LayerNorms take the fused kernels (ccmh_torch/ops/layernorm.py)
under ``set_ln_impl("fused")``; ``ln_pre``, ``ln_post`` and ``ln_final``
stay plain, as in ``ccmh``.  This
slice ports the ``pooled`` features; the ``tokens``/``mith`` modes,
``need_weights``, per-example key-padding masks and the head-major
(tensor-parallel) layout come later.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

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
                         attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over [B, L, D] with a fused qkv projection.

    ``attn_bias`` is an additive fp32 [L, L] mask (0 / -inf) or None."""
    if ATTN_IMPL == "fused" and (attn_bias is None or attn_bias.ndim == 2):
        # feed the RAW x @ qkv_w product; the kernel folds qkv_b into its
        # load, saving the [B, L, 3D] round trip of a standalone bias add
        ctx = fused_attention(x @ p["qkv_w"], attn_bias, n_head, qkv_b=p["qkv_b"])
    else:
        ctx = attention_reference(x @ p["qkv_w"] + p["qkv_b"], attn_bias, n_head)
    return ctx @ p["out_w"] + p["out_b"]


def _block(x: torch.Tensor, p: Params, n_head: int,
           attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Pre-LN residual attention block (attention + QuickGELU MLP)."""
    fused = LN_IMPL == "fused"
    ln = fused_layer_norm if fused else layer_norm
    h = ln(x, p["ln_1"]["scale"], p["ln_1"]["bias"])
    attn_out = multi_head_attention(h, p["attn"], n_head, attn_bias)
    if fused:
        # the residual add + pre-MLP LN in one pass (kernel #5)
        h, x = fused_add_layer_norm(x, attn_out, p["ln_2"]["scale"], p["ln_2"]["bias"])
    else:
        x = x + attn_out
        h = layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"])
    mlp = p["mlp"]
    return x + (quick_gelu(h @ mlp["fc_w"] + mlp["fc_b"]) @ mlp["proj_w"] + mlp["proj_b"])


def _layer(tree: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def transformer(x: torch.Tensor, stacked: Params, n_head: int,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the blocks in order over the stacked layer parameters.

    Weights in another dtype than ``x`` are cast per layer (LayerNorm still
    reduces in fp32); :func:`cast_clip_params` casts them once instead."""
    n_layers = stacked["ln_1"]["scale"].shape[0]
    for i in range(n_layers):
        layer = _layer(stacked, i)
        if layer["ln_1"]["scale"].dtype != x.dtype:
            layer = _map(lambda t: t.to(x.dtype), layer)
        x = _block(x, layer, n_head, attn_bias)
    return x


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
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ViT forward -> pooled [B, E] embedding (reference
    model/base/model.py:228-252)."""
    if images.dtype == torch.uint8:
        images = normalize_pixels(images)
    x = patchify(images.to(dtype), cfg.vision_patch_size)
    x = x @ p["patch_w"].to(dtype)                         # [B, P, W]
    B = x.shape[0]
    cls = p["class_embedding"].to(dtype).expand(B, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + p["positional_embedding"].to(dtype)
    x = layer_norm(x, p["ln_pre"]["scale"], p["ln_pre"]["bias"])
    x = transformer(x, p["blocks"], cfg.vision_heads, None)
    pooled = layer_norm(x[:, 0, :], p["ln_post"]["scale"], p["ln_post"]["bias"])
    return pooled @ p["proj"].to(dtype)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------

def causal_mask(length: int, device: Any = "cpu") -> torch.Tensor:
    """Additive [L, L] causal bias (0 on/below diagonal, -inf above)."""
    keep = torch.ones((length, length), dtype=torch.bool, device=device).tril()
    return torch.zeros((length, length), device=device).masked_fill(~keep, -math.inf)


def text_forward(p: Params, cfg: ClipConfig, ids: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Causal text transformer with EOT pooling -> pooled [B, E].

    ``ids``: integer [B, L] (L <= context_length; the positional embedding
    is sliced to L).  The EOT position is ``argmax(ids)`` (the EOT id is
    the largest in the vocab; the first maximum wins, as in ``ccmh``)."""
    B, L = ids.shape
    ids = ids.long()
    x = p["token_embedding"].to(dtype)[ids]               # [B, L, W]
    x = x + p["positional_embedding"].to(dtype)[:L]
    x = transformer(x, p["blocks"], cfg.transformer_heads,
                    causal_mask(L, device=x.device))
    eos_pos = ids.argmax(dim=-1)                           # [B]
    h = layer_norm(x, p["ln_final"]["scale"], p["ln_final"]["bias"])
    pooled = h[torch.arange(B, device=h.device), eos_pos]
    return pooled @ p["text_projection"].to(dtype)


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
