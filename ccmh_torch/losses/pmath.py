"""Poincaré-ball operations (DHaPH's hyperbolic geometry).

Port of ``ccmh/losses/pmath.py`` (itself the geoopt-derived ops of
train/DHaPH/pmath.py:11-107, 270-300, 409-487): clamped tanh and artanh,
the projection into the ball, the exponential map at the origin, batched
Möbius addition, pairwise geodesic distances, and the two functions with
a gradient of their own, ``ccmh``'s ``jax.custom_vjp`` s, as
``torch.autograd.Function`` s (:class:`Artanh`, :class:`RiemannianGradient`).

Clips and floors are taken with ``torch.maximum`` / ``torch.minimum``
against a tensor: like ``jnp.clip`` and ``jnp.maximum`` they split the
gradient where the operands are equal (``torch.clamp`` does not).
"""

from __future__ import annotations

import torch

_EDGE = 1e-5   # artanh's clamp: |x| <= 1 - 1e-5


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def tanh_clamp(x: torch.Tensor, clamp: float = 15.0) -> torch.Tensor:
    return torch.tanh(_clip(x, -clamp, clamp))


class Artanh(torch.autograd.Function):
    """artanh of the input clamped to ±(1 - 1e-5); the backward is
    ``g / (1 - xc²)`` at the *clamped* input xc (pmath.py:24-27), so it
    stays finite at and beyond the clamp."""

    @staticmethod
    def forward(ctx, x):
        xc = torch.clamp(x, -1 + _EDGE, 1 - _EDGE)
        ctx.save_for_backward(xc)
        return 0.5 * (torch.log1p(xc) - torch.log1p(-xc))

    @staticmethod
    def backward(ctx, g):
        (xc,) = ctx.saved_tensors
        return g / (1 - xc ** 2)


def artanh(x: torch.Tensor) -> torch.Tensor:
    return Artanh.apply(x)


class RiemannianGradient(torch.autograd.Function):
    """The identity forward; the backward scales the gradient by the inverse
    conformal factor squared, (1 - c‖x‖²)² / 4 (pmath.py:30-45)."""

    @staticmethod
    def forward(ctx, x, c: float):
        ctx.save_for_backward(x)
        ctx.c = c
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale = (1 - ctx.c * (x * x).sum(-1, keepdim=True)) ** 2 / 4
        return g * scale, None


def riemannian_gradient(x: torch.Tensor, c: float) -> torch.Tensor:
    return RiemannianGradient.apply(x, c)


def project(x: torch.Tensor, c: float) -> torch.Tensor:
    """Clip points to stay strictly inside the ball (pmath.py:94-99)."""
    norm = torch.maximum(torch.linalg.vector_norm(x, dim=-1, keepdim=True), _const(x, 1e-5))
    maxnorm = (1 - 1e-3) / (c ** 0.5)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def expmap0(u: torch.Tensor, c: float) -> torch.Tensor:
    """Exp map at the origin (pmath.py:296-300)."""
    sqrt_c = c ** 0.5
    u_norm = torch.maximum(torch.linalg.vector_norm(u, dim=-1, keepdim=True), _const(u, 1e-5))
    return tanh_clamp(sqrt_c * u_norm) * u / (sqrt_c * u_norm)


def mobius_addition_batch(x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    """All-pairs Möbius addition -> [B, C, D] (HPloss.py:14-25)."""
    xy = x @ y.T                                          # [B, C]
    x2 = (x * x).sum(-1, keepdim=True)                    # [B, 1]
    y2 = (y * y).sum(-1, keepdim=True)                    # [C, 1]
    num = 1 + 2 * c * xy + c * y2.T                       # [B, C]
    num = num[:, :, None] * x[:, None, :] + (1 - c * x2)[:, :, None] * y[None, :, :]
    denom = 1 + 2 * c * xy + (c ** 2) * x2 * y2.T
    return num / (denom[:, :, None] + 1e-5)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a zero (not NaN) gradient at the
    origin, written as ``ccmh`` writes it."""
    sq = (x * x).sum(-1)
    is_zero = sq < 1e-24
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(is_zero, zero, torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))


def dist_matrix(x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    """Pairwise Poincaré geodesic distances (HPloss.py:46-57)."""
    sqrt_c = c ** 0.5
    add = mobius_addition_batch(-x, y, c)
    return (2.0 / sqrt_c) * artanh(sqrt_c * _safe_norm(add))
