"""Fused multi-head self-attention for short sequences: forward (kernel A)
and backward (kernel C), tied together as a ``torch.autograd.Function``.

Port of ``ccmh/ops/attention.py``: the Pallas forward ``_pallas_forward`` /
``_kernel`` as ``ccmh_torch/csrc/attention.cu`` and the Pallas backward
``_pallas_backward`` / ``_bwd_kernel`` as ``ccmh_torch/csrc/attention_bwd.cu``,
CUDA C++ for Hopper.  One block per (batch element, head) keeps the head on
chip: the forward runs the fp32 softmax without writing the [L, L] logits to
device memory; the backward recomputes them, likewise on chip, and writes
dq, dk and dv into one packed [B, L, 3D] gradient.  Every product runs on
the tensor cores (``mma.sync``: bf16, or fp32 as 3xTF32, which keeps fp32's
accuracy), one warp per 16-row tile, with the head's rows loaded by 16-byte
``cp.async`` copies where they are aligned (``csrc/mma_tiles.cuh``).

:class:`FusedAttention` is ``ccmh``'s ``jax.custom_vjp``: it saves only the
raw ``qkv``, the mask and ``qkv_b`` (``_fwd``), and its backward is kernel C
plus the (B, L) sum for ``d qkv_b`` (``_bwd``); the mask gets no gradient.
:func:`attention_reference` and :func:`attention_backward_reference` beside
them are the plain PyTorch versions.  A CPU tensor takes the plain versions
(so the CPU tests exercise the Function's wiring); a CUDA tensor launches
the kernels or raises.

Sequences past 128 tokens (ViT-B/16's 197, ViT-L/14's 257, ViT-L/14@336's
577, MITH's concept transformers at K > 128) take the kernels' long path,
chosen by the C entries from L: the head streams through shared memory in
64-row tiles, the softmax still normalised before its probabilities are
rounded, and the backward still free of atomics.  With head dim 64 and
16-byte aligned tensors (every tower), bf16 or fp32, the long path runs on
Hopper's warpgroup products (``wgmma``) fed by TMA
(``csrc/wgmma_tiles.cuh``; fp32 as 3xTF32 on ``wgmma .tf32``); the bf16
forward up to :data:`ONEPASS_MAX_L` tokens in one pass over the keys, its
logits in registers, and past it in two (up to :data:`RESIDENT_MAX_L` over
the head's keys held in shared memory); the bf16 backward up to
:data:`BWD_ONEPASS_MAX_L` tokens with its query side in one kernel (each
row's probabilities in registers: row statistics and dq) and its dk dv
kernel after it, past it in three kernels; other long shapes take the
``mma.sync`` kernels of ``csrc/attention_long.cuh``.
The C entries choose by that fixed rule and report the family they took
(``ccmh_attention_{fwd,bwd}_family``); the wrapper counts launches by
family in :data:`launches_by_family` and
:data:`backward_launches_by_family`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ccmh_torch.ops import build

# launches of the CUDA kernels since the counts were last set to 0
launches = 0            # the forward, kernel A
backward_launches = 0   # the backward, kernel C
# the same launches by the kernel family the C entry took: "short" (L <= 128),
# "long_mma" (the long path on mma.sync), "long_wgmma" (on wgmma, two passes
# over the keys streamed a query tile), "long_onepass" on wgmma in bf16 (the
# forward in one pass up to ONEPASS_MAX_L keys; the backward's query side in
# one kernel up to BWD_ONEPASS_MAX_L) and "long_resident" (the bf16 forward's
# two passes over the head's keys held in shared memory, up to
# RESIDENT_MAX_L)
FAMILIES = ("short", "long_mma", "long_wgmma", "long_onepass", "long_resident")  # codes 0-4
launches_by_family = dict.fromkeys(FAMILIES, 0)
backward_launches_by_family = dict.fromkeys(FAMILIES, 0)

# L <= SHORT_SEQ: a warp keeps its [16, L] logits in registers; past it
# the C entries take the long path, which streams 64-row tiles of the head
# (csrc/attention_long.cuh) up to MAX_SEQ (its row statistics in shared
# memory and the mask's int offsets)
SHORT_SEQ = 128
# the forward in bf16 at head dim 64 up to this L holds a warpgroup's whole
# [64, L] logit tile in registers, and past it up to RESIDENT_MAX_L the
# head's k and v in shared memory (csrc/attention_family.cuh kOnePassMaxL,
# kResidentMaxL)
ONEPASS_MAX_L = 336
RESIDENT_MAX_L = 768
# the backward in bf16 at head dim 64 up to this L holds a warpgroup's
# [64, L] fp32 probabilities in registers (kBwdOnePassMaxL); its two
# kernels pass each row's four fp32 statistics through a buffer that the
# wrapper allocates, [B, H, L, STATS_WIDTH], as do the three past it
BWD_ONEPASS_MAX_L = 272
STATS_WIDTH = 4
MAX_SEQ = 4096
MAX_HEAD_DIM = 128   # a warp's [16, Dh] products in registers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                        n_head: int,
                        qkv_b: Optional[torch.Tensor] = None,
                        need_weights: bool = False):
    """Plain PyTorch attention, [B, L, 3D] packed q|k|v -> [B, L, D].

    ``qkv_b`` is added in the input type, logits and softmax are fp32,
    the probabilities are rounded to the input type before ``p . v``,
    which accumulates in fp32 and is stored in the input type.  ``bias``
    is [L, L] or a per-example [B, 1, L, L].  With ``need_weights`` it
    returns ``(context, probabilities averaged over heads [B, L, L])``."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    head_dim = D // n_head
    if qkv_b is not None:
        qkv = qkv + qkv_b.to(qkv.dtype)
    q, k, v = qkv.reshape(B, L, 3, n_head, head_dim).unbind(2)  # [B, L, H, Dh]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(head_dim))
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    ctx = ctx.to(qkv.dtype).reshape(B, L, D)
    return (ctx, probs.mean(1)) if need_weights else ctx


def _check(qkv, bias, n_head, qkv_b) -> None:
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [B, L, 3D], got {list(qkv.shape)}")
    B, L, D3 = qkv.shape
    if n_head < 1 or (D3 // 3) % n_head:
        raise ValueError(f"D={D3 // 3} is not divisible by n_head={n_head}")
    if bias is not None and tuple(bias.shape) != (L, L):
        raise ValueError(f"bias must be [L, L] = [{L}, {L}], got {list(bias.shape)}")
    if qkv_b is not None and tuple(qkv_b.shape) != (D3,):
        raise ValueError(f"qkv_b must be [{D3}], got {list(qkv_b.shape)}")
    for name, t in (("bias", bias), ("qkv_b", qkv_b)):
        if t is not None and t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")


def _check_kernel_inputs(qkv, bias, n_head, qkv_b) -> None:
    B, L, D3 = qkv.shape
    head_dim = D3 // 3 // n_head
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not 1 <= L <= MAX_SEQ or not 1 <= head_dim <= MAX_HEAD_DIM or B < 1:
        raise ValueError(f"the attention kernel takes 1 <= L <= {MAX_SEQ} and "
                         f"1 <= head_dim <= {MAX_HEAD_DIM} (got B={B}, L={L}, "
                         f"head_dim={head_dim})")
    if L > SHORT_SEQ and head_dim * qkv.element_size() < 12:
        # the mma.sync long backward keeps each row's three fp32 statistics in its
        # dq slot (the bf16 wgmma kernels in a buffer of their own)
        raise ValueError(f"past L = {SHORT_SEQ} the attention kernel takes head_dim * "
                         f"itemsize >= 12 bytes (got head_dim={head_dim}, {qkv.dtype})")
    if qkv_b is not None and qkv_b.dtype != qkv.dtype:
        raise TypeError(f"qkv_b must be {qkv.dtype}, got {qkv_b.dtype}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    for name, t in (("qkv", qkv), ("bias", bias), ("qkv_b", qkv_b)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def attention_backward_reference(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                                 qkv_b: Optional[torch.Tensor], g: torch.Tensor,
                                 n_head: int) -> torch.Tensor:
    """Plain PyTorch backward of :func:`attention_reference` with respect to
    the raw ``qkv`` -> packed [B, L, 3D] ``dqkv``, step by step after
    ``ccmh``'s ``_bwd_kernel``: ``g`` and ``qkv + qkv_b`` in the input type,
    the softmax recomputed in fp32, ``dprobs = g . v`` and
    ``dlogits = probs * (dprobs - sum(dprobs * probs))`` in fp32, then
    ``probs`` and ``dlogits * scale`` rounded to the input type before the
    three output products, which accumulate in fp32."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    head_dim = D // n_head
    scale = 1.0 / math.sqrt(head_dim)
    dtype = qkv.dtype
    if qkv_b is not None:
        qkv = qkv + qkv_b.to(dtype)
    q, k, v = (t.float() for t in qkv.reshape(B, L, 3, n_head, head_dim).unbind(2))
    g = g.to(dtype).reshape(B, L, n_head, head_dim).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    dprobs = torch.einsum("bqhd,bkhd->bhqk", g, v)
    dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    probs_c = probs.to(dtype).float()
    dlogits_c = (dlogits * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits_c, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits_c, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs_c, g)
    return torch.stack([dq, dk, dv], dim=2).to(dtype).reshape(B, L, D3)


def _entry(name: str):
    """(library, C entry) of kernel ``name`` with its argument types."""
    if name == "fwd":
        lib = build.load("attention")
        fn = lib.ccmh_attention_fwd
        n_ptrs = 4      # qkv, qkv_b, mask, out
    else:
        lib = build.load("attention_bwd")
        fn = lib.ccmh_attention_bwd
        n_ptrs = 6      # qkv, qkv_b, mask, g, dqkv, stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def _family(kind: str, ptrs, L: int, head_dim: int, dtype: torch.dtype) -> str:
    """The family of the kernel that the C entry of ``kind`` launches for
    these pointers and shape, as that entry reports it."""
    lib = build.load("attention" if kind == "fwd" else "attention_bwd")
    fn = getattr(lib, f"ccmh_attention_{kind}_family")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 3
    return FAMILIES[fn(*ptrs, L, head_dim, _DTYPE_CODES[dtype])]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bwd_stats(qkv: torch.Tensor, n_head: int) -> Optional[torch.Tensor]:
    """The bf16 long backward's scratch for each row's softmax statistics,
    [B, H, L, STATS_WIDTH] fp32 (its query side writes them, its dk dv
    kernel reads them), or None where the C entry takes none (L <= 128,
    fp32)."""
    B, L, _ = qkv.shape
    if L <= SHORT_SEQ or qkv.dtype != torch.bfloat16:
        return None
    return torch.empty((B, n_head, L, STATS_WIDTH), dtype=torch.float32, device=qkv.device)


def _device_of(qkv: torch.Tensor, what: str) -> str:
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {qkv.device}")
    return qkv.device.type


def _forward(qkv, bias, n_head, qkv_b):
    global launches
    if _device_of(qkv, "fused_attention") == "cpu":
        return attention_reference(qkv, bias, n_head, qkv_b)
    _check_kernel_inputs(qkv, bias, n_head, qkv_b)
    B, L, D3 = qkv.shape
    head_dim = D3 // 3 // n_head
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib, fn = _entry("fwd")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.device.index, _ptr(qkv), _ptr(qkv_b), _ptr(bias), _ptr(out),
             B, L, n_head, head_dim, 1.0 / math.sqrt(head_dim),
             _DTYPE_CODES[qkv.dtype], stream)
    build.raise_on_error(lib, "ccmh_attention_fwd", err)
    launches += 1
    launches_by_family[_family("fwd", (_ptr(qkv), _ptr(qkv_b), _ptr(out)), L, head_dim,
                               qkv.dtype)] += 1
    return out


def attention_backward(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                       qkv_b: Optional[torch.Tensor], g: torch.Tensor,
                       n_head: int) -> torch.Tensor:
    """Gradient of :func:`fused_attention` with respect to the raw ``qkv``
    for the output cotangent ``g`` [B, L, D] -> packed [B, L, 3D] in the
    input type.  A CPU tensor takes :func:`attention_backward_reference`; a
    CUDA tensor launches kernel C on PyTorch's current stream, or raises."""
    global backward_launches
    _check(qkv, bias, n_head, qkv_b)
    B, L, D3 = qkv.shape
    if tuple(g.shape) != (B, L, D3 // 3):
        raise ValueError(f"g must be [{B}, {L}, {D3 // 3}], got {list(g.shape)}")
    if g.device != qkv.device:
        raise ValueError(f"g is on {g.device}, qkv on {qkv.device}")
    if _device_of(qkv, "attention_backward") == "cpu":
        return attention_backward_reference(qkv, bias, qkv_b, g, n_head)
    _check_kernel_inputs(qkv, bias, n_head, qkv_b)
    g = g.to(qkv.dtype)          # ccmh casts the cotangent to the input type
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    head_dim = D3 // 3 // n_head
    dqkv = torch.empty_like(qkv)
    stats = _bwd_stats(qkv, n_head)
    lib, fn = _entry("bwd")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.device.index, _ptr(qkv), _ptr(qkv_b), _ptr(bias), _ptr(g), _ptr(dqkv),
             _ptr(stats), B, L, n_head, head_dim, 1.0 / math.sqrt(head_dim),
             _DTYPE_CODES[qkv.dtype], stream)
    build.raise_on_error(lib, "ccmh_attention_bwd", err)
    backward_launches += 1
    backward_launches_by_family[_family("bwd", (_ptr(qkv), _ptr(qkv_b), _ptr(g), _ptr(dqkv)),
                                        L, head_dim, qkv.dtype)] += 1
    return dqkv


class FusedAttention(torch.autograd.Function):
    """Kernel A forward, kernel C backward (``ccmh``'s ``custom_vjp``).

    Saves only the raw ``qkv``, the mask and ``qkv_b``; the backward
    recomputes the softmax.  ``d qkv_b`` is the (B, L) sum of ``dqkv``
    (``qkv_b`` enters as ``qkv + b``); the mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, qkv_b, n_head):
        ctx.n_head = n_head
        ctx.save_for_backward(qkv, bias, qkv_b)
        return _forward(qkv, bias, n_head, qkv_b)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, qkv_b = ctx.saved_tensors
        dqkv = attention_backward(qkv, bias, qkv_b, g.contiguous(), ctx.n_head)
        d_qkv_b = None
        if qkv_b is not None and ctx.needs_input_grad[2]:
            d_qkv_b = dqkv.sum((0, 1)).to(qkv_b.dtype)
        return (dqkv if ctx.needs_input_grad[0] else None), None, d_qkv_b, None


def fused_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                    n_head: int,
                    qkv_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention over packed ``qkv`` [B, L, 3D] -> [B, L, D],
    differentiable through :class:`FusedAttention`.

    ``bias`` is an additive fp32 [L, L] mask (causal for text) or None, and
    gets no gradient; ``qkv_b`` the [3D] projection bias, folded into the
    kernels' loads (pass the RAW ``x @ qkv_w`` product as ``qkv`` then).  A
    CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    on PyTorch's current stream, or raises."""
    _check(qkv, bias, n_head, qkv_b)
    if bias is not None:
        bias = bias.detach()
    return FusedAttention.apply(qkv, bias, qkv_b, n_head)
