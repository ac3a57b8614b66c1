"""The train step's FLOP and byte model, and the card's rates.

Every count here comes from the configuration's shapes, so a floor (the
least time the card could take for a part of the step) needs no compiler
cost analysis.  The counts are those of ``torch.utils.flop_counter``: two
FLOPs a multiply-add of every matrix product and convolution, nothing for
softmax, LayerNorm, BatchNorm, activations or adds.
``tests/test_torch_floors.py`` holds them to ``FlopCounterMode`` over the
port's plain forward and backward, exactly, and to XLA's cost analysis of
``ccmh``'s encode (which also counts elementwise work), from below.

* :func:`tower_flops`, the towers' forward at batch B, split by the rate
  its products run at on the card: ``"gemm"`` (cuBLAS and cuDNN in the
  compute type; the ModifiedResNet tower's attention pool too) and
  ``"attention"`` (``q kᵀ`` and ``p v`` of the attention kernels #1/#2);
* :func:`tower_backward_flops`, their backward as the function needs
  it, the floor's count: twice the forward's products, less the input
  gradient of the patch embedding or of the ModifiedResNet stem's first
  convolution (the images take none);
* :func:`tower_backward_executed_flops`, the backward as the port runs
  it: that count, plus the work the implementation chooses, the
  attention kernel's backward recomputing ``q kᵀ`` (five products where
  the plain formulation's autograd takes four) and, under ``remat``, one
  more forward of the checkpointed blocks but their last product;
* :func:`optimizer_bytes`, from the optimizers' real state: each
  parameter read and written, its gradient read, and each state tensor of
  its shape read and written, at the dtypes they have (BertAdam: 28 bytes
  a parameter with fp32 moments, 20 with bf16 ones);
* :data:`PEAK_OPS_PER_S` and :data:`HBM_BYTES_PER_S`, the one table of the
  card's rates that the port's tools and ``chip_smoke.py`` read;
* :data:`TOWERS`, the tower configurations the tools take by name.
"""

from __future__ import annotations

from typing import Dict, Iterable

from ccmh_torch.clip.model import ClipConfig

# NVIDIA H100 SXM (H100 80GB HBM3, 700 W) published peaks, dense.  The
# port runs fp32 matrix products and convolutions with TF32 off
# (ccmh_torch/__init__.py), so an fp32 GEMM counts at the fp32 FMA rate;
# the attention kernels #1/#2 run their fp32 products as 3xTF32 (three
# TF32 products each), a third of the TF32 rate.  The data sheet gives no
# one-bit rate: wgmma's one-bit product takes 256 bits of K a step where
# int8's takes 32 at the same shape otherwise, so b1 is 8x int8
# (``python -m ccmh_torch.tools.time_hamming --rate`` measures it).
CARD = "NVIDIA H100 80GB HBM3, 700 W"
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "3xtf32": 495e12 / 3,
    "float32": 67e12,
    "int8": 1979e12,
    "b1": 8 * 1979e12,
    "popc": 132 * 16 * 1.98e9,      # SIMT __popc: 16 a clock an SM at 1.98 GHz
}
# the rate of each class of tower products, by the towers' compute type
GEMM_OP_TYPE = {"float32": "float32", "bfloat16": "bfloat16"}
ATTN_OP_TYPE = {"float32": "3xtf32", "bfloat16": "bfloat16"}
TEXT_LEN = 32          # the training batches' caption length (max_words)


def bound(n_bytes: float, n_ops: float, op_type: str):
    """(ms, "bytes" or "operations"): the larger of ``n_bytes`` over the
    memory rate and ``n_ops`` over the peak rate of ``op_type``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rn50_config() -> ClipConfig:
    """OpenAI's RN50 (openai/CLIP clip/model.py build_model and
    ModifiedResNet): stages of 3, 4, 6 and 3 bottlenecks from a width-64
    stem, a 32-head attention pool over 7x7 + 1 tokens 2,048 wide, a
    1,024-wide embedding and ViT-B/32's 12-layer text tower."""
    return ClipConfig(embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
                      vision_width=64, vision_patch_size=None, context_length=77,
                      vocab_size=49408, transformer_width=512, transformer_heads=8,
                      transformer_layers=12)


def rn_tiny_config() -> ClipConfig:
    """A ModifiedResNet tower at toy sizes (every block kind: a stride-1
    stage with a downsample, strided stages), for the CPU."""
    return ClipConfig(embed_dim=64, image_resolution=64, vision_layers=(2, 1, 1, 2),
                      vision_width=8, vision_patch_size=None, transformer_width=128,
                      transformer_heads=2, transformer_layers=2)


TOWERS = {"vit-b-32": ClipConfig, "vit-l-14": ClipConfig.vit_l14, "rn50": rn50_config}


def tower_config(name: str, tiny: bool = False) -> ClipConfig:
    """The tower ``name`` of :data:`TOWERS`; ``tiny``, a toy tower of the
    same family (``ClipConfig.tiny()`` or :func:`rn_tiny_config`)."""
    if name not in TOWERS:
        raise ValueError(f"tower must be one of {sorted(TOWERS)}, got {name!r}")
    if tiny:
        return rn_tiny_config() if name == "rn50" else ClipConfig.tiny()
    return TOWERS[name]()


def _blocks(layers: int, width: int, tokens: int, B: int):
    """(gemm, attention) FLOPs of ``layers`` blocks: qkv, output and the
    two MLP projections, 2 B L W (3 W + W + 4 W + 4 W); ``q kᵀ`` and ``p v``
    over all heads, 2 x 2 B L² W (the full [L, L], causal or not)."""
    return layers * 24 * B * tokens * width ** 2, layers * 4 * B * tokens ** 2 * width


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _conv(B: int, out: int, k: int, cin: int, cout: int) -> int:
    return 2 * B * out * out * k * k * cin * cout


def _resnet(cfg: ClipConfig, B: int):
    """(gemm FLOPs of the ModifiedResNet tower, those of its stem's first
    convolution): the three stem convolutions, each bottleneck's 1x1,
    3x3 and 1x1 (the 3x3 before the block's average pool, the last 1x1
    after it) and its downsample's 1x1 after the pool, the attention
    pool's q (the mean row only), k, v and output projections and its
    two products over the H W + 1 tokens."""
    w = cfg.vision_width
    s = _out(cfg.image_resolution, 3, 2, 1)
    first = _conv(B, s, 3, 3, w // 2)
    flops = first + _conv(B, s, 3, w // 2, w // 2) + _conv(B, s, 3, w // 2, w)
    s //= 2
    inplanes = w
    for li, n_blocks in enumerate(cfg.vision_layers, start=1):
        planes = w * 2 ** (li - 1)
        for bi in range(n_blocks):
            stride = 2 if (li > 1 and bi == 0) else 1
            flops += _conv(B, s, 1, inplanes, planes) + _conv(B, s, 3, planes, planes)
            s_out = s // stride
            flops += _conv(B, s_out, 1, planes, 4 * planes)
            if stride > 1 or inplanes != 4 * planes:
                flops += _conv(B, s_out, 1, inplanes, 4 * planes)
            s, inplanes = s_out, 4 * planes
    C, tokens = 32 * w, s * s + 1
    flops += 2 * B * C * C + 2 * 2 * B * tokens * C * C + 2 * 2 * B * tokens * C
    return flops + 2 * B * C * cfg.embed_dim, first


def _vision(cfg: ClipConfig, B: int, features: str):
    """(gemm, attention, first) of the vision tower; ``first`` the patch
    embedding or the stem's first convolution, whose input takes no
    gradient."""
    if cfg.is_resnet:
        if features != "pooled":
            raise ValueError("the ModifiedResNet tower gives the pooled embedding only")
        gemm, first = _resnet(cfg, B)
        return gemm, 0, first
    vw, L = cfg.vision_width, cfg.n_patches + 1
    first = 2 * B * cfg.n_patches * 3 * cfg.vision_patch_size ** 2 * vw
    gemm, attn = _blocks(cfg.vision_layers, vw, L, B)
    rows = L if features == "mith" else 1
    return first + gemm + 2 * B * rows * vw * cfg.embed_dim, attn, first


def _text(cfg: ClipConfig, B: int, text_len: int, features: str):
    tw = cfg.transformer_width
    gemm, attn = _blocks(cfg.transformer_layers, tw, text_len, B)
    rows = text_len if features == "mith" else 1
    return gemm + 2 * B * rows * tw * cfg.embed_dim, attn


def _check_features(features: str) -> None:
    if features not in ("pooled", "tokens", "mith"):
        raise ValueError(f"features must be 'pooled', 'tokens' or 'mith', got {features!r}")


def tower_flops(cfg: ClipConfig, B: int, text_len: int = TEXT_LEN,
                features: str = "pooled") -> Dict[str, int]:
    """The forward of both towers at batch B on ``text_len``-token
    captions: ``{"gemm", "attention", "total"}`` FLOPs.  ``features`` is
    the towers' mode (``"tokens"`` computes what ``"pooled"`` does;
    ``"mith"`` projects every token)."""
    _check_features(features)
    vg, va, _ = _vision(cfg, B, features)
    tg, ta = _text(cfg, B, text_len, features)
    return {"gemm": vg + tg, "attention": va + ta, "total": vg + tg + va + ta}


def encode_flops(cfg: ClipConfig, B: int, text_len: int = TEXT_LEN) -> int:
    """FLOPs of one pooled image + text encode pair at batch B."""
    return tower_flops(cfg, B, text_len)["total"]


def tower_backward_flops(cfg: ClipConfig, B: int, text_len: int = TEXT_LEN,
                         features: str = "pooled") -> Dict[str, int]:
    """The towers' backward at batch B as the function needs it (the
    floor's count): ``{"gemm", "attention", "total"}``.  Every product
    takes the gradients of both operands (2x its forward) but the patch
    embedding's or the stem's first convolution, whose input (the images)
    takes none (1x)."""
    _check_features(features)
    vg, va, first = _vision(cfg, B, features)
    tg, ta = _text(cfg, B, text_len, features)
    gemm, attention = 2 * (vg + tg) - first, 2 * (va + ta)
    return {"gemm": gemm, "attention": attention, "total": gemm + attention}


def tower_backward_executed_flops(cfg: ClipConfig, B: int, text_len: int = TEXT_LEN,
                                  features: str = "pooled", attn: str = "fused",
                                  remat=False, key_padding: bool = False) -> Dict[str, int]:
    """The towers' backward at batch B as the port runs it:
    :func:`tower_backward_flops` plus the work the implementation chooses.
    An attention layer on the kernel (``attn="fused"``) runs #2, which
    recomputes ``q kᵀ``: one [L, L] product more than autograd's four; a
    layer in the plain formulation (``attn="plain"``; under ``"mith"`` the
    last block of each tower, which returns its weights; the text tower's
    blocks under a per-example ``key_padding`` bias) takes autograd's four.
    ``remat`` (True or ``"full"``) recomputes each block's forward in
    backward up to its last product, the MLP's output projection, whose
    output the backward does not read (PyTorch's checkpoint stops
    recomputing there): 16 B L W² and the two attention products a block.
    The last block under ``"mith"`` stays unchecked; the ModifiedResNet
    tower takes no remat.  ``"dots"`` keeps the matrix products and is not
    counted."""
    if attn not in ("fused", "plain"):
        raise ValueError(f"attn must be 'fused' or 'plain', got {attn!r}")
    if remat not in (False, True, "full"):
        raise ValueError(f"remat must be False, True or 'full', got {remat!r}")
    floor = tower_backward_flops(cfg, B, text_len, features)
    gemm, attention = floor["gemm"], floor["attention"]
    mith = features == "mith"
    towers = [(_text(cfg, B, text_len, features)[1], cfg.transformer_layers,
               cfg.transformer_width, text_len, attn == "plain" or key_padding)]
    if not cfg.is_resnet:
        towers.append((_vision(cfg, B, features)[1], cfg.vision_layers, cfg.vision_width,
                       cfg.n_patches + 1, attn == "plain"))
    for fwd, layers, width, tokens, plain in towers:
        per_layer = fwd // layers // 2          # one [L, L] product over all heads
        n_plain = layers if plain else int(mith)
        attention += per_layer * (layers - n_plain)
        if remat:
            checked = layers - int(mith)
            gemm += 16 * B * tokens * width ** 2 * checked
            attention += 2 * per_layer * checked
    return {"gemm": gemm, "attention": attention, "total": gemm + attention}


def tower_floor_ms(flops: Dict[str, int], dtype: str) -> float:
    """ms of ``flops`` ({"gemm", "attention"}) at the card's rates for
    towers computing in ``dtype``."""
    return 1e3 * (flops["gemm"] / PEAK_OPS_PER_S[GEMM_OP_TYPE[dtype]]
                  + flops["attention"] / PEAK_OPS_PER_S[ATTN_OP_TYPE[dtype]])


def clip_param_count(cfg: ClipConfig) -> int:
    """Parameters of the CLIP tree (``ccmh``'s layout: the logit scale,
    the stacked blocks' LayerNorms and biases, BatchNorm's mean and var)."""
    def blocks(layers, width):
        return layers * (12 * width ** 2 + 13 * width)

    tw, E = cfg.transformer_width, cfg.embed_dim
    text = (cfg.vocab_size * tw + cfg.context_length * tw + blocks(cfg.transformer_layers, tw)
            + 2 * tw + tw * E)
    if not cfg.is_resnet:
        vw = cfg.vision_width
        vision = (3 * cfg.vision_patch_size ** 2 * vw + vw + (cfg.n_patches + 1) * vw
                  + 4 * vw + blocks(cfg.vision_layers, vw) + vw * E)
        return vision + text + 1
    w = cfg.vision_width
    vision = 9 * 3 * (w // 2) + 9 * (w // 2) ** 2 + 9 * (w // 2) * w + 4 * (w + 2 * (w // 2))
    inplanes = w
    for li, n_blocks in enumerate(cfg.vision_layers, start=1):
        planes = w * 2 ** (li - 1)
        for bi in range(n_blocks):
            vision += inplanes * planes + 9 * planes ** 2 + 4 * planes ** 2 + 4 * 6 * planes
            if (li > 1 and bi == 0) or inplanes != 4 * planes:
                vision += inplanes * 4 * planes + 4 * 4 * planes
            inplanes = 4 * planes
    C = 32 * w
    vision += ((cfg.image_resolution // 32) ** 2 + 1) * C + 3 * (C * C + C) + C * E + E
    return vision + text + 1


def optimizer_bytes(optimizers: Iterable) -> int:
    """Bytes one step of ``optimizers`` moves at the least, from the state
    they hold (after a step): each parameter read and written, its
    gradient read (the parameter's size where it has none: BertAdam
    steps it on zeros), and each tensor of the parameter's shape in its
    state read and written, at the dtypes they have."""
    total = 0
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                moments = [t for k, t in state.items() if k != "step"
                           and hasattr(t, "shape") and t.shape == p.shape]
                g = p.grad if p.grad is not None else p
                total += 2 * p.nbytes + g.nbytes + 2 * sum(t.nbytes for t in moments)
    return total
