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
rounded, and the backward still free of atomics (``csrc/attention_long.cuh``).
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

# L <= SHORT_SEQ: a warp keeps its [16, L] logits in registers; past it
# the C entries take the long path, which streams 64-row tiles of the head
# (csrc/attention_long.cuh) up to MAX_SEQ (its row statistics in shared
# memory and the mask's int offsets)
SHORT_SEQ = 128
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
        # the long backward keeps each row's three fp32 statistics in its dq slot
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
        n_ptrs = 5      # qkv, qkv_b, mask, g, dqkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
    lib, fn = _entry("bwd")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.device.index, _ptr(qkv), _ptr(qkv_b), _ptr(bias), _ptr(g), _ptr(dqkv),
             B, L, n_head, head_dim, 1.0 / math.sqrt(head_dim),
             _DTYPE_CODES[qkv.dtype], stream)
    build.raise_on_error(lib, "ccmh_attention_bwd", err)
    backward_launches += 1
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
