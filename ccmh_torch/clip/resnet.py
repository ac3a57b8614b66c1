"""ModifiedResNet CLIP vision tower (the RN50 family) in PyTorch.

Port of ``ccmh/clip/resnet.py``, on a parameter tree in ``ccmh``'s layout
so that weights cross between the two packages unchanged
(``ccmh_torch/bridge.py``) and ``.npz`` files stay interchangeable:

* conv kernels HWIO ``[kh, kw, cin, cout]``, permuted to PyTorch's OIHW at
  the call; BatchNorm as ``scale / bias / mean / var``; the attention
  pool's projections ``[in, out]`` (``y = x @ w + b``); the blocks of a
  stage keyed ``"0"``, ``"1"``, ... under ``layer1`` .. ``layer4``;
* images arrive NHWC ``[B, R, R, 3]``; their NCHW view is already in the
  ``channels_last`` memory format, which the tower keeps, so the
  convolutions take cuDNN's NHWC kernels;
* BatchNorm is arithmetic on the parameters, as in ``ccmh``: the running
  ``mean`` and ``var`` are leaves of the tree, get gradients and train
  like any other weight (``F.batch_norm`` in eval mode would give them
  none);
* the attention pool computes only the mean token's query row (the one
  the reference returns), with fp32 logits and softmax.

Convolutions, pooling and the pool's attention are plain PyTorch (cuDNN
and cuBLAS on the card): ``ccmh``'s tower runs no Pallas kernel either.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ccmh_torch.clip.model import _normal, _uniform

Params = Dict[str, Any]

_BN_EPS = 1e-5


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCHW (``channels_last``) ``x`` by an HWIO kernel."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=padding)


def _bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """BatchNorm on its parameters' statistics: an fp32 scale and bias,
    cast to ``x``'s dtype, over the channel axis."""
    inv = torch.rsqrt(p["var"].float() + _BN_EPS)
    scale32 = p["scale"].float()
    scale = (scale32 * inv).to(x.dtype)
    bias = (p["bias"].float() - p["mean"].float() * scale32 * inv).to(x.dtype)
    return x * scale[:, None, None] + bias[:, None, None]


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """The VALID k x k window mean at stride k (floor at odd sizes)."""
    return x if k <= 1 else F.avg_pool2d(x, k, k)


def _bottleneck(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = F.relu(_bn(_conv(out, p["conv2"], padding=1), p["bn2"]))
    out = _avg_pool(out, stride)
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity = _bn(_conv(_avg_pool(x, stride), p["downsample"]["conv"]),
                       p["downsample"]["bn"])
    else:
        identity = x
    return F.relu(out + identity)


def _attn_pool(x: torch.Tensor, p: Params, n_head: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, out_dim] by mean-query attention
    (model/base/model.py:57-92 of the reference)."""
    B, C = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)                  # [B, HW, C]
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p["positional_embedding"].to(x.dtype)

    head_dim = C // n_head
    q = tokens[:, :1] @ p["q_w"] + p["q_b"]                # only the mean row
    k = tokens @ p["k_w"] + p["k_b"]
    v = tokens @ p["v_w"] + p["v_b"]

    def heads(t):
        return t.reshape(B, -1, n_head, head_dim).transpose(1, 2)   # [B, h, {1|L}, d]

    q, k, v = heads(q), heads(k), heads(v)
    # fp32 logits of the compute-dtype operands (exact products, fp32 sums)
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(head_dim))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = (probs @ v).transpose(1, 2).reshape(B, 1, C)
    return (ctx @ p["c_w"] + p["c_b"])[:, 0]


def _cast(tree: Params, dtype: torch.dtype) -> Params:
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def resnet_forward(p: Params, cfg, images: torch.Tensor, *,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ModifiedResNet forward: NHWC [B, R, R, 3] -> [B, embed_dim].  Every
    leaf is cast to ``dtype`` first, as ``ccmh`` casts them."""
    x = images.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    stem = _cast(p["stem"], dtype)
    for i in (1, 2, 3):
        x = F.relu(_bn(_conv(x, stem[f"conv{i}"], stride=2 if i == 1 else 1, padding=1),
                       stem[f"bn{i}"]))
    x = _avg_pool(x, 2)
    for li, n_blocks in enumerate(cfg.vision_layers, start=1):
        layer = _cast(p[f"layer{li}"], dtype)
        for bi in range(n_blocks):
            x = _bottleneck(x, layer[str(bi)], 2 if (li > 1 and bi == 0) else 1)
    n_head = (cfg.vision_width * 32) // 64
    return _attn_pool(x, _cast(p["attnpool"], dtype), n_head)


# ---------------------------------------------------------------------------
# OpenAI state dict -> parameter tree (numpy, on the host)
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv_w(sd, key) -> np.ndarray:
    return np.ascontiguousarray(_np(sd[key]).transpose(2, 3, 1, 0))   # OIHW -> HWIO


def _bn_p(sd, prefix) -> Params:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]),
            "var": _np(sd[f"{prefix}.running_var"])}


def convert_resnet_visual(sd: Dict[str, Any], vision_layers: Sequence[int]) -> Params:
    """The ``visual.*`` entries of an RN-family CLIP state dict -> the
    tower's tree of float32 numpy arrays (``num_batches_tracked`` is not
    read)."""
    v: Params = {"stem": {}}
    for i in (1, 2, 3):
        v["stem"][f"conv{i}"] = _conv_w(sd, f"visual.conv{i}.weight")
        v["stem"][f"bn{i}"] = _bn_p(sd, f"visual.bn{i}")
    for li, n_blocks in enumerate(vision_layers, start=1):
        layer: Params = {}
        for bi in range(n_blocks):
            pre = f"visual.layer{li}.{bi}"
            blk: Params = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = _conv_w(sd, f"{pre}.conv{ci}.weight")
                blk[f"bn{ci}"] = _bn_p(sd, f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": _conv_w(sd, f"{pre}.downsample.0.weight"),
                                     "bn": _bn_p(sd, f"{pre}.downsample.1")}
            layer[str(bi)] = blk
        v[f"layer{li}"] = layer
    pool = "visual.attnpool"
    v["attnpool"] = {"positional_embedding": _np(sd[f"{pool}.positional_embedding"])}
    for name in ("q", "k", "v", "c"):
        v["attnpool"][f"{name}_w"] = np.ascontiguousarray(_np(sd[f"{pool}.{name}_proj.weight"]).T)
        v["attnpool"][f"{name}_b"] = _np(sd[f"{pool}.{name}_proj.bias"])
    return v


# ---------------------------------------------------------------------------
# from-scratch init (ccmh's distributions: model/base/model.py:315-325 of
# the reference and torch's Conv2d / Linear defaults)
# ---------------------------------------------------------------------------

def _kaiming_conv(gen: torch.Generator, h: int, w: int, cin: int, cout: int) -> torch.Tensor:
    bound = math.sqrt(6.0 / ((1 + 5.0) * h * w * cin))    # kaiming_uniform(a=sqrt(5))
    return _uniform(gen, (h, w, cin, cout), bound)


def _bn_init(c: int, device, zero_scale: bool = False) -> Params:
    return {"scale": (torch.zeros if zero_scale else torch.ones)((c,), device=device),
            "bias": torch.zeros((c,), device=device),
            "mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


def init_resnet_visual(gen: torch.Generator, cfg) -> Params:
    """A random ModifiedResNet tower drawn from ``gen`` on ``gen.device``
    (``ccmh``'s distributions, not its numbers); each block's ``bn3``
    scale is zero."""
    dev = gen.device
    width = cfg.vision_width
    v: Params = {"stem": {
        "conv1": _kaiming_conv(gen, 3, 3, 3, width // 2), "bn1": _bn_init(width // 2, dev),
        "conv2": _kaiming_conv(gen, 3, 3, width // 2, width // 2),
        "bn2": _bn_init(width // 2, dev),
        "conv3": _kaiming_conv(gen, 3, 3, width // 2, width), "bn3": _bn_init(width, dev),
    }}
    inplanes = width
    for li, n_blocks in enumerate(cfg.vision_layers, start=1):
        planes = width * 2 ** (li - 1)
        layer: Params = {}
        for bi in range(n_blocks):
            stride = 2 if (li > 1 and bi == 0) else 1
            blk = {
                "conv1": _kaiming_conv(gen, 1, 1, inplanes, planes), "bn1": _bn_init(planes, dev),
                "conv2": _kaiming_conv(gen, 3, 3, planes, planes), "bn2": _bn_init(planes, dev),
                "conv3": _kaiming_conv(gen, 1, 1, planes, planes * 4),
                "bn3": _bn_init(planes * 4, dev, zero_scale=True),
            }
            if stride > 1 or inplanes != planes * 4:
                blk["downsample"] = {"conv": _kaiming_conv(gen, 1, 1, inplanes, planes * 4),
                                     "bn": _bn_init(planes * 4, dev)}
            layer[str(bi)] = blk
            inplanes = planes * 4
        v[f"layer{li}"] = layer

    embed = width * 32
    std = embed ** -0.5
    spacial = cfg.image_resolution // 32
    lin_bound = 1.0 / math.sqrt(embed)
    v["attnpool"] = {"positional_embedding": _normal(gen, (spacial ** 2 + 1, embed), std)}
    for name in ("q", "k", "v"):
        v["attnpool"][f"{name}_w"] = _normal(gen, (embed, embed), std)
        v["attnpool"][f"{name}_b"] = _uniform(gen, (embed,), lin_bound)
    v["attnpool"]["c_w"] = _normal(gen, (embed, cfg.embed_dim), std)
    v["attnpool"]["c_b"] = _uniform(gen, (cfg.embed_dim,), lin_bound)
    return v
