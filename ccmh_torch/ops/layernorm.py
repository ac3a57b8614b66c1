"""Fused LayerNorm (kernel #4) and residual add + LayerNorm (kernel #5),
each tied to its closed-form backward as a ``torch.autograd.Function``.

Port of ``ccmh/ops/layernorm.py``: the Pallas forwards ``_ln_forward`` /
``_ln_kernel`` and ``_add_ln_forward`` / ``_add_ln_kernel`` as
``ccmh_torch/csrc/layernorm.cu``, CUDA C++ for Hopper: one warp per row,
16-byte loads and stores, the row, scale and bias held in registers packed
in their own types; ``x`` (and ``d``) read once, ``y`` (and the sum ``s``)
written once.  Rows that cannot be read 16 bytes at a time take the
same kernel's scalar branch (:func:`_vector_path` decides).  ``ccmh``'s
backward is plain XLA (``_ln_vjp``, the closed-form VJP on the saved
input), so the port's is plain PyTorch.

:func:`layer_norm_reference` and :func:`add_layer_norm_reference` beside
the kernels are the plain versions, with the kernels' rounding points: the
residual add in the input type, fp32 statistics with the biased variance
(``jnp.var``), ``rsqrt(var + 1e-5)``, the affine step with ``scale`` and
``bias`` widened to fp32, one rounding back to the input type.  A CPU
tensor takes the plain versions (so the CPU tests exercise the Functions'
wiring); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ccmh_torch.ops import build

# launches of the CUDA kernels since the counts were last set to 0
launches = 0            # kernel #4, ln_forward
add_launches = 0        # kernel #5, add_ln_forward

EPS = 1e-5
MAX_WIDTH = 1024        # the kernel keeps up to 32 values of a row per lane
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = EPS) -> torch.Tensor:
    """Plain LayerNorm over the last axis (any leading shape): fp32
    statistics with the biased variance, cast back to the input type."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def add_layer_norm_reference(x: torch.Tensor, d: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``(LayerNorm(x + d), x + d)``; the sum is rounded to the input
    type before the statistics, as ``ccmh``'s kernel rounds it."""
    s = x + d
    return layer_norm_reference(s, scale, bias), s


def layer_norm_backward_reference(s: torch.Tensor, scale: torch.Tensor, g: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ccmh``'s ``_ln_vjp``: the closed-form LayerNorm backward on the
    saved input ``s`` [rows, W] for the cotangent ``g`` -> (dx in the input
    type, dscale in the scale's type, dbias in fp32)."""
    s32, g32 = s.float(), g.float()
    mean = s32.mean(-1, keepdim=True)
    var = (s32 - mean).square().mean(-1, keepdim=True)
    invstd = torch.rsqrt(var + EPS)
    xhat = (s32 - mean) * invstd
    dscale = (g32 * xhat).sum(0)
    dbias = g32.sum(0)
    dxhat = g32 * scale.float()
    dx = invstd * (dxhat - dxhat.mean(-1, keepdim=True)
                   - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(s.dtype), dscale.to(scale.dtype), dbias


def _check_kernel_inputs(x2d: torch.Tensor, d2d: Optional[torch.Tensor],
                         scale: torch.Tensor, bias: torch.Tensor) -> None:
    rows, W = x2d.shape
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"the LayerNorm kernels take float32 or bfloat16, got {x2d.dtype}")
    if not 1 <= W <= MAX_WIDTH or rows < 1:
        raise ValueError(f"the LayerNorm kernels take 1 <= W <= {MAX_WIDTH} and at "
                         f"least one row (got rows={rows}, W={W})")
    if scale.dtype not in _DTYPE_CODES or bias.dtype != scale.dtype:
        raise TypeError(f"scale and bias must both be float32 or bfloat16, got "
                        f"{scale.dtype} and {bias.dtype}")
    if tuple(scale.shape) != (W,) or tuple(bias.shape) != (W,):
        raise ValueError(f"scale and bias must be [{W}], got {list(scale.shape)} "
                         f"and {list(bias.shape)}")
    if d2d is not None and (d2d.dtype != x2d.dtype or d2d.shape != x2d.shape):
        raise ValueError(f"the residual must match x ({x2d.dtype} {list(x2d.shape)}), "
                         f"got {d2d.dtype} {list(d2d.shape)}")
    for name, t in (("x", x2d), ("residual", d2d), ("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vector_path(x2d: torch.Tensor, d2d: Optional[torch.Tensor], y: torch.Tensor,
                 s: Optional[torch.Tensor], scale: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether the kernel may take its 16-byte branch: a row of W values
    is a whole number of 16-byte chunks in the input type and in the
    parameter type, and every pointer is 16-byte aligned.  Otherwise it
    takes its scalar branch (W = 100 in bf16, a view one element in)."""
    W = x2d.shape[-1]
    if (W * x2d.element_size()) % 16 or (W * scale.element_size()) % 16:
        return False
    return all(t.data_ptr() % 16 == 0 for t in (x2d, d2d, y, s, scale, bias) if t is not None)


# (library, C entry) of kernel #4 (False) and #5 (True), resolved with the
# argument types on first use, once per process
_ENTRIES: dict = {}


def _c_entry(add: bool):
    """(library, C entry) of kernel #5 (``add``) or #4 with its argument
    types, from the cache."""
    hit = _ENTRIES.get(add)
    if hit is None:
        lib = build.load("layernorm")
        fn = lib.ccmh_add_ln_forward if add else lib.ccmh_ln_forward
        n_ptrs = 6 if add else 4   # x, [d], scale, bias, y, [s]
        fn.restype = ctypes.c_int
        # device, pointers, rows, W, dtype, param_dtype, vector, stream
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        hit = _ENTRIES[add] = (lib, fn)
    return hit


def _launch(x2d: torch.Tensor, d2d: Optional[torch.Tensor], scale: torch.Tensor,
            bias: torch.Tensor, y: torch.Tensor, s: Optional[torch.Tensor], device: int,
            stream: int) -> None:
    """Kernel #5 (``d2d`` given) or #4 on checked inputs into the allocated
    outputs, on ``device``'s ``stream``; raises if the launch was refused."""
    add = d2d is not None
    lib, fn = _c_entry(add)
    rows, W = x2d.shape
    ptrs = [t.data_ptr() for t in (x2d, d2d, scale, bias, y, s) if t is not None]
    err = fn(device, *ptrs, rows, W, _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[scale.dtype],
             int(_vector_path(x2d, d2d, y, s, scale, bias)), stream)
    build.raise_on_error(lib, "ccmh_add_ln_forward" if add else "ccmh_ln_forward", err)


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    return x.device.type


def ln_forward(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel #4 on [rows, W]: a CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on PyTorch's current stream, or raises."""
    global launches
    if _device_of(x2d, "fused_layer_norm") == "cpu":
        return layer_norm_reference(x2d, scale, bias)
    _check_kernel_inputs(x2d, None, scale, bias)
    y = torch.empty_like(x2d)
    _launch(x2d, None, scale, bias, y, None, x2d.device.index,
            torch.cuda.current_stream(x2d.device).cuda_stream)
    launches += 1
    return y


def add_ln_forward(x2d: torch.Tensor, d2d: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #5 on [rows, W] -> (y, s = x + d), as :func:`ln_forward`."""
    global add_launches
    if _device_of(x2d, "fused_add_layer_norm") == "cpu":
        return add_layer_norm_reference(x2d, d2d, scale, bias)
    _check_kernel_inputs(x2d, d2d, scale, bias)
    y, s = torch.empty_like(x2d), torch.empty_like(x2d)
    _launch(x2d, d2d, scale, bias, y, s, x2d.device.index,
            torch.cuda.current_stream(x2d.device).cuda_stream)
    add_launches += 1
    return y, s


class FusedLayerNorm(torch.autograd.Function):
    """Kernel #4 forward, ``ccmh``'s closed-form VJP backward (saves x)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias):
        ctx.save_for_backward(x2d, scale, bias)
        return ln_forward(x2d, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x2d, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward_reference(x2d, scale, g)
        return dx, dscale, dbias.to(bias.dtype)


class FusedAddLayerNorm(torch.autograd.Function):
    """Kernel #5 forward -> (y, s); backward on the saved sum ``s``.  ``s``
    feeds both outputs, so ``x`` and ``d`` get the same gradient: the
    LayerNorm VJP of ``y``'s cotangent plus ``s``'s own.  Either cotangent
    may be None (an output that reaches no loss)."""

    @staticmethod
    def forward(ctx, x2d, d2d, scale, bias):
        ctx.set_materialize_grads(False)
        y, s = add_ln_forward(x2d, d2d, scale, bias)
        ctx.save_for_backward(s, scale, bias)
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):
        s, scale, bias = ctx.saved_tensors
        if gy is None:
            dx = None if gs is None else gs.to(s.dtype)
            return dx, dx, None, None
        dx, dscale, dbias = layer_norm_backward_reference(s, scale, gy)
        if gs is not None:
            dx = dx + gs.to(dx.dtype)
        return dx, dx, dscale, dbias.to(bias.dtype)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One-pass LayerNorm over the last axis (any leading shape),
    differentiable through :class:`FusedLayerNorm`."""
    shape = x.shape
    return FusedLayerNorm.apply(x.reshape(-1, shape[-1]), scale, bias).reshape(shape)


def fused_add_layer_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(LayerNorm(x + delta), x + delta)`` in one pass: the residual add
    and pre-LN pair of every transformer block."""
    shape = x.shape
    y, s = FusedAddLayerNorm.apply(x.reshape(-1, shape[-1]), delta.reshape(-1, shape[-1]),
                                   scale, bias)
    return y.reshape(shape), s.reshape(shape)
