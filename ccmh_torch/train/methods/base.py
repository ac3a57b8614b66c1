"""Method protocol (port of ``ccmh/train/methods/base.py``).

A Method bundles what the Trainer and serving need from one of the hashing
methods:

* ``init``          — build head/extra/aux parameter trees;
* ``loss``          — CLIP forward + heads + method loss, the body of the
                      train step (``make_loss_fn`` binds the config);
* ``encode_image``  — images -> ±1 image codes;
* ``encode_text``   — token ids -> ±1 text codes;
* ``multi_encode``, ``custom_step`` — optional, as in ``ccmh`` (TwDH's
  per-length codes, DGHDGH's sequenced step).

``ccmh`` encodes one modality by returning one output of its joint
``encode`` under ``jit`` and letting XLA drop the other tower.  PyTorch
runs eagerly, so the port's methods carry one encode function per tower,
and the joint :meth:`Method.encode` is their composition; a ``needs_mask``
method's ``encode_text`` builds the key-padding mask ``ids == 0`` itself,
as ``ccmh``'s Retriever does for it.  ``jax.random`` keys become an
explicit ``torch.Generator`` (dropout of the linear heads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ccmh_torch.clip.model import (
    ClipConfig, TextOutput, VisionOutput, text_forward, vision_forward,
)
from ccmh_torch.config import Config
from ccmh_torch.models.heads import init_linear_hash, linear_hash
from ccmh_torch.parallel.mesh import gather_outputs
from ccmh_torch.ops.packing import sign_codes

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
    # optional: (cfg, extra) -> the optimizer of the loss-side ``extra``
    # parameters (ccmh's extra_tx), stepped after BertAdam; None where this
    # config leaves them frozen (DNPH's default)
    extra_optimizer: Optional[Callable[[Config, Params], Optional[torch.optim.Optimizer]]] = None
    features: str = "pooled"       # the towers' output mode the method reads
    needs_mask: bool = False       # batches carry key_padding_mask = ids == 0 (MITH)
    # a global gradient-norm clip of the main parameters before BertAdam's
    # per-tensor clip (DPSIH: train/DPSIH/hash_train.py:70-71, at 2.0)
    grad_clip: float = 0.0
    # optional: (params, aux, batch {"image", "text", "valid"}, cfg, clip_cfg)
    #   -> {name: (img ±1, txt ±1)}, the per-length codes of a multi-length
    # method (TwDH), validated after ``valid`` (Trainer.valid_multi)
    multi_encode: Optional[Callable[..., Dict[str, Tuple[torch.Tensor, torch.Tensor]]]] = None
    # optional: (cfg, clip_cfg, optimizer, extra_optimizer) -> a
    # ``(state, batch) -> (state, metrics)`` step replacing the generic one,
    # or None to keep it (DGHDGH's three-phase sequencing)
    custom_step: Optional[Callable] = None
    # encode_image takes ``valid=`` [B] bool, the eval batch's real rows
    # (TwDH's train-mode BatchNorm statistics count only those)
    encode_takes_valid: bool = False

    def make_loss_fn(self, cfg: Config, clip_cfg: ClipConfig):
        """``(params, extra, aux, batch, generator) -> (loss, (aux, metrics))``."""
        if self.loss is None:
            raise NotImplementedError(f"{self.name} has no loss in ccmh_torch yet")

        def loss_fn(params, extra, aux, batch, generator):
            return self.loss(params, extra, aux, batch, generator, cfg, clip_cfg)
        return loss_fn

    def encode(self, params: Params, aux: Params, batch: Dict[str, torch.Tensor],
               cfg: Config, clip_cfg: ClipConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch {"image", "text"} (and "valid" for a method that takes it)
        -> (image codes, text codes)."""
        kw = ({"valid": batch.get("valid")} if self.encode_takes_valid else {})
        return (self.encode_image(params, aux, batch["image"], cfg, clip_cfg, **kw),
                self.encode_text(params, aux, batch["text"], cfg, clip_cfg))


def make_linear_hash_method(
    name: str,
    loss_body: Callable[..., Tuple[torch.Tensor, Any]],
    *,
    init_heads: Optional[Callable[[torch.Generator, Config, ClipConfig], Params]] = None,
    init_extra: Optional[Callable[[torch.Generator, Config, ClipConfig], Params]] = None,
    extra_optimizer: Optional[Callable[[Config, Params], torch.optim.Optimizer]] = None,
) -> Method:
    """Factory of the plain-LinearHash methods (``ccmh``'s
    ``make_linear_hash_method``): LinearHash heads with dropout, sign
    codes per tower; only the loss and the trees beside the heads differ.

    ``loss_body(hash_img, hash_txt, batch, params, extra, aux, generator,
    cfg) -> (loss, metrics)``; it draws any randomness of its own from
    ``generator`` after the heads' dropout.  No ported LinearHash method
    keeps ``aux`` state, so the factory has no ``init_aux`` (``ccmh``'s
    has one).
    ``init_heads`` adds trees to the head trees (they train under BertAdam
    at the head lr, as DMsH_LN's label net does); ``init_extra`` builds the
    loss-side ``extra`` tree that ``extra_optimizer`` steps.  ``ccmh``
    writes DSPH, DMsH_LN, DScPH and DDWSH out by hand with the same heads
    and encode; the port builds all of them here."""
    def _init(gen: torch.Generator, cfg: Config, clip_cfg: ClipConfig):
        heads = {
            "img_head": init_linear_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
            "txt_head": init_linear_hash(gen, clip_cfg.embed_dim, cfg.output_dim),
        }
        if init_heads is not None:
            heads.update(init_heads(gen, cfg, clip_cfg))
        extra = init_extra(gen, cfg, clip_cfg) if init_extra else None
        return heads, extra, {}

    def _loss(params, extra, aux, batch, generator, cfg: Config, clip_cfg: ClipConfig):
        img, txt = clip_embeds(params, clip_cfg, batch, cfg)
        hi = linear_hash(params["img_head"], img.pooled, train=True, generator=generator)
        ht = linear_hash(params["txt_head"], txt.pooled, train=True, generator=generator)
        loss, metrics = loss_body(hi, ht, batch, params, extra, aux, generator, cfg)
        return loss, (aux, metrics)

    def _encode_image(params, aux, images, cfg: Config, clip_cfg: ClipConfig):
        return sign_codes(linear_hash(params["img_head"],
                                      image_embeds(params, clip_cfg, images, cfg)))

    def _encode_text(params, aux, ids, cfg: Config, clip_cfg: ClipConfig):
        return sign_codes(linear_hash(params["txt_head"],
                                      text_embeds(params, clip_cfg, ids, cfg)))

    return Method(name=name, init=_init, encode_image=_encode_image,
                  encode_text=_encode_text, loss=_loss, extra_optimizer=extra_optimizer)


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


def _cast_floats_f32(out):
    """Every floating tensor of a tower output in fp32 (heads and losses
    keep fp32 numerics under bf16 towers)."""
    return type(out)(*[t.float() if t is not None and t.is_floating_point() else t
                       for t in out])


def resolve_remat(cfg: Optional[Config]):
    """The towers' activation checkpointing in the train step, as ``ccmh``
    reads it: False, or ``cfg.remat_policy`` ("full" or "dots") under
    ``cfg.remat``."""
    if not getattr(cfg, "remat", False):
        return False
    return getattr(cfg, "remat_policy", "full")


def image_features(params: Params, clip_cfg: ClipConfig, images: torch.Tensor,
                   cfg: Optional[Config] = None, *, features: str = "pooled",
                   dtype=None, remat=False) -> VisionOutput:
    """The vision tower's outputs in mode ``features``, in the run's compute
    dtype, every floating output in fp32 (model/modelbase.py:69-96).

    Under an active mesh (``parallel/mesh.py``) ``images`` are this rank's
    rows of the global batch, and every output comes back gathered over
    the data axis in rank order: the heads and the loss after it see the
    global batch, as in ``ccmh``'s one-program mesh step."""
    dtype = resolve_compute_dtype(cfg) if dtype is None else dtype
    return gather_outputs(_cast_floats_f32(vision_forward(
        params["clip"]["visual"], clip_cfg, images, dtype=dtype, features=features,
        remat=remat)))


def text_features(params: Params, clip_cfg: ClipConfig, ids: torch.Tensor,
                  cfg: Optional[Config] = None, *, features: str = "pooled",
                  key_padding_mask: Optional[torch.Tensor] = None, dtype=None,
                  remat=False) -> TextOutput:
    """The text tower's outputs, as :func:`image_features` (gathered under
    an active mesh)."""
    dtype = resolve_compute_dtype(cfg) if dtype is None else dtype
    return gather_outputs(_cast_floats_f32(text_forward(
        params["clip"]["text"], clip_cfg, ids, dtype=dtype, features=features,
        key_padding_mask=key_padding_mask, remat=remat)))


def image_embeds(params: Params, clip_cfg: ClipConfig, images: torch.Tensor,
                 cfg: Optional[Config] = None, *, dtype=None) -> torch.Tensor:
    """Pooled fp32 image embeddings [B, E]."""
    return image_features(params, clip_cfg, images, cfg, dtype=dtype).pooled


def text_embeds(params: Params, clip_cfg: ClipConfig, ids: torch.Tensor,
                cfg: Optional[Config] = None, *, dtype=None) -> torch.Tensor:
    """Pooled fp32 text embeddings [B, E]."""
    return text_features(params, clip_cfg, ids, cfg, dtype=dtype).pooled


def clip_embeds(params: Params, clip_cfg: ClipConfig, batch: Dict[str, torch.Tensor],
                cfg: Optional[Config] = None, *, features: str = "pooled", dtype=None
                ) -> Tuple[VisionOutput, TextOutput]:
    """Both towers in mode ``features``, fp32 out; the text tower takes the
    batch's ``key_padding_mask`` where it has one.  Every method's loss
    comes here, and here alone the run's ``remat`` applies, as in ``ccmh``;
    it and every encoder reach the towers through :func:`image_features`
    and :func:`text_features`, the mesh's seam.  A profile of the step
    finds them under the range "towers" (``ccmh_torch/tools/step_split.py``)."""
    remat = resolve_remat(cfg)
    with torch.profiler.record_function("towers"):
        return (image_features(params, clip_cfg, batch["image"], cfg, features=features,
                               dtype=dtype, remat=remat),
                text_features(params, clip_cfg, batch["text"], cfg, features=features,
                              key_padding_mask=batch.get("key_padding_mask"), dtype=dtype,
                              remat=remat))
