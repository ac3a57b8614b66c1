"""Similarity primitives of the method losses (port of
``ccmh/ops/similarity.py``, itself utils/utils.py:26-69 of the reference).

``jnp.maximum`` and ``torch.maximum`` both split the gradient 0.5/0.5 where
their operands are equal; ``torch.clamp`` does not.  The floors here are
taken with ``torch.maximum`` against a tensor, so the gradient at the floor
matches ``ccmh``'s.
"""

from __future__ import annotations

import torch


def calc_neighbor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Label-overlap indicator: (a @ b.T > 0) as float32."""
    return ((a.float() @ b.float().T) > 0).float()


def _floor(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.maximum(x, torch.tensor(eps, dtype=x.dtype, device=x.device))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / _floor(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise-normalized inner products."""
    return l2_normalize(a) @ l2_normalize(b).T


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - cosine_similarity(a, b)


def euclidean_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pairwise euclidean distances by the inner-product expansion.  On the
    diagonal of an a-vs-a matrix the squared distance hits the ``eps``
    floor, and the gradient there is split as ``ccmh``'s is."""
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    sq = a2 + b2.T - 2.0 * (a @ b.T)
    return torch.sqrt(_floor(sq, eps))
