"""Method protocol (port of ``ccmh/train/methods/base.py``).

A Method bundles what the Trainer and serving need from one of the hashing
methods:

* ``init``          — build head/extra/aux parameter trees;
* ``loss``          — CLIP forward + heads + method loss, the body of the
                      train step (``make_loss_fn`` binds the config);
* ``encode_image``  — images -> ±1 image codes;
* ``encode_text``   — token ids -> ±1 text codes.

``ccmh`` encodes one modality by returning one output of its joint
``encode`` under ``jit`` and letting XLA drop the other tower.  PyTorch
runs eagerly, so the port's methods carry one encode function per tower,
and the joint :meth:`Method.encode` is their composition.  ``jax.random``
keys become an explicit ``torch.Generator`` (dropout of the linear heads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ccmh_torch.clip.model import ClipConfig, text_forward, vision_forward
from ccmh_torch.config import Config

Params = Dict[str, Any]


@dataclasses.dataclass
class Method:
    name: str
    # (generator, cfg, clip_cfg) -> (heads, extra | None, aux)
    init: Callable[[torch.Generator, Config, ClipConfig], Tuple[Params, Optional[Params], Params]]
    # (params, aux, images [B, H, W, 3], cfg, clip_cfg) -> ±1 int8 [B, K]
    encode_image: Callable[..., torch.Tensor]
    # (params, aux, ids [B, L], cfg, clip_cfg) -> ±1 int8 [B, K]
    encode_text: Callable[..., torch.Tensor]
    # (params, extra, aux, batch, generator, cfg, clip_cfg)
    #   -> (loss, (new_aux, metrics)); batch {"image", "text", "label"}
    loss: Optional[Callable[..., Tuple[torch.Tensor, Tuple[Params, Dict[str, torch.Tensor]]]]] = None
    # optional: cfg -> (q, r) -> int32 distances replacing plain Hamming
    dist_fn: Optional[Callable[[Config], Callable]] = None
    # optional: cfg -> optimizer factory for the loss-side ``extra``
    # parameters (ccmh's extra_tx); no ported method has one yet
    extra_optimizer: Optional[Callable[[Config], Any]] = None

    def make_loss_fn(self, cfg: Config, clip_cfg: ClipConfig):
        """``(params, extra, aux, batch, generator) -> (loss, (aux, metrics))``."""
        if self.loss is None:
            raise NotImplementedError(f"{self.name} has no loss in ccmh_torch yet")

        def loss_fn(params, extra, aux, batch, generator):
            return self.loss(params, extra, aux, batch, generator, cfg, clip_cfg)
        return loss_fn

    def encode(self, params: Params, aux: Params, batch: Dict[str, torch.Tensor],
               cfg: Config, clip_cfg: ClipConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch {"image", "text"} -> (image codes, text codes)."""
        return (self.encode_image(params, aux, batch["image"], cfg, clip_cfg),
                self.encode_text(params, aux, batch["text"], cfg, clip_cfg))


def resolve_compute_dtype(cfg: Optional[Config]) -> torch.dtype:
    """The tower compute dtype: ``bfloat16`` runs both CLIP towers in bf16
    (fp32 LayerNorm/softmax inside, fp32 embeds out); ``float32`` is the
    default.  Unknown values raise instead of silently running fp32."""
    if cfg is None:
        return torch.float32
    name = str(cfg.compute_dtype)
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "fp32", "f32"):
        return torch.float32
    raise ValueError(
        f"unsupported compute_dtype {name!r}; use 'float32' or 'bfloat16'")


def image_embeds(params: Params, clip_cfg: ClipConfig, images: torch.Tensor,
                 cfg: Optional[Config] = None, *, dtype=None) -> torch.Tensor:
    """Pooled fp32 image embeddings [B, E] through the vision tower in the
    run's compute dtype (model/modelbase.py:69-96)."""
    dtype = resolve_compute_dtype(cfg) if dtype is None else dtype
    return vision_forward(params["clip"]["visual"], clip_cfg, images, dtype=dtype).float()


def text_embeds(params: Params, clip_cfg: ClipConfig, ids: torch.Tensor,
                cfg: Optional[Config] = None, *, dtype=None) -> torch.Tensor:
    """Pooled fp32 text embeddings [B, E] through the text tower."""
    dtype = resolve_compute_dtype(cfg) if dtype is None else dtype
    return text_forward(params["clip"]["text"], clip_cfg, ids, dtype=dtype).float()


def clip_embeds(params: Params, clip_cfg: ClipConfig, batch: Dict[str, torch.Tensor],
                cfg: Optional[Config] = None, *, dtype=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both towers: (image embeds, text embeds), fp32 out."""
    return (image_embeds(params, clip_cfg, batch["image"], cfg, dtype=dtype),
            text_embeds(params, clip_cfg, batch["text"], cfg, dtype=dtype))
