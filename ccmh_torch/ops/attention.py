"""Fused multi-head self-attention forward for short sequences (kernel A).

Port of the forward of ``ccmh/ops/attention.py`` (the Pallas kernel
``_pallas_forward`` / ``_kernel``) as a CUDA C++ kernel for Hopper,
``ccmh_torch/csrc/attention.cu``: one block per (batch element, head)
keeps the head's q, k and v in shared memory and runs the fp32 softmax
without writing the [L, L] logits to device memory.  The only device
memory traffic is the packed [B, L, 3D] qkv read and the [B, L, D]
context write.

:func:`attention_reference` beside it is the plain PyTorch version (the
math of ``ccmh``'s ``_xla_attention`` with the projection-bias fold of
``_kernel``).  :func:`fused_attention` takes it for CPU tensors only; a
CUDA tensor launches the kernel or raises.  The backward kernel comes
with the training slice, so the wrapper refuses a CUDA input that
requires grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ccmh_torch.ops import build

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_SEQ = 128        # the kernel keeps up to 4 keys per lane in registers
MAX_HEAD_DIM = 128   # ... and up to 4 head dims per lane
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                        n_head: int,
                        qkv_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch attention, [B, L, 3D] packed q|k|v -> [B, L, D].

    ``qkv_b`` is added in the input type, logits and softmax are fp32,
    the probabilities are rounded to the input type before ``p . v``,
    which accumulates in fp32 and is stored in the input type."""
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
    return ctx.to(qkv.dtype).reshape(B, L, D)


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
    if torch.is_grad_enabled() and (qkv.requires_grad or (
            qkv_b is not None and qkv_b.requires_grad)):
        raise RuntimeError("fused_attention on CUDA is forward only (its "
                           "backward kernel is not ported yet); run under "
                           "torch.inference_mode() or torch.no_grad()")
    if qkv_b is not None and qkv_b.dtype != qkv.dtype:
        raise TypeError(f"qkv_b must be {qkv.dtype}, got {qkv_b.dtype}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    for name, t in (("qkv", qkv), ("bias", bias), ("qkv_b", qkv_b)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_fn():
    lib = build.load("attention")
    fn = lib.ccmh_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def fused_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                    n_head: int,
                    qkv_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention over packed ``qkv`` [B, L, 3D] -> [B, L, D].

    ``bias`` is an additive fp32 [L, L] mask (causal for text) or None;
    ``qkv_b`` the [3D] projection bias, folded into the kernel's load (pass
    the RAW ``x @ qkv_w`` product as ``qkv`` then).  A CPU tensor takes
    :func:`attention_reference`; a CUDA tensor launches the kernel on
    PyTorch's current stream, or raises."""
    global launches
    _check(qkv, bias, n_head, qkv_b)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, bias, n_head, qkv_b)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, got {qkv.device}")
    _check_kernel_inputs(qkv, bias, n_head, qkv_b)
    B, L, D3 = qkv.shape
    D = D3 // 3
    head_dim = D // n_head
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    lib, fn = _kernel_fn()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.device.index, qkv.data_ptr(), None if qkv_b is None else qkv_b.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             B, L, n_head, head_dim, 1.0 / math.sqrt(head_dim),
             _DTYPE_CODES[qkv.dtype], stream)
    build.raise_on_error(lib, "ccmh_attention_fwd", err)
    launches += 1
    return out
