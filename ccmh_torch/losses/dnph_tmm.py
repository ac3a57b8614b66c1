"""DNpH quadratic spherical mutual information loss (TMM'24).

Port of ``ccmh/losses/dnph_tmm.py`` (train/DNpH_TMM/loss.py:5-72,
qmi_loss): cosine kernel matrices shifted to [0, 1], square-clamp form
summed over the image-image, text-text and image-text pairs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _cos_kernel(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    a = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + eps)
    b = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + eps)
    return 0.5 * (a @ b.T + 1.0)


def _rbf(a: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    aa = (a * a).sum(1)[:, None]
    bb = (b * b).sum(1)[None, :]
    d = torch.maximum(aa + bb - 2 * a @ b.T, torch.zeros((), device=a.device))
    return torch.exp(-d / (2 * sigma ** 2))


def qmi_loss(images: torch.Tensor, texts: torch.Tensor, targets: torch.Tensor,
             *, sigma: float = 3.0, m: float = 0.0, eps: float = 1e-8,
             use_cosine: bool = True, use_square_clamp: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if use_cosine:
        Y = _cos_kernel(images, images, eps)
        T = _cos_kernel(texts, texts, eps)
        YT = _cos_kernel(images, texts, eps)
    else:
        Y, T, YT = _rbf(images, images, sigma), _rbf(texts, texts, sigma), _rbf(images, texts, sigma)

    D = ((targets @ targets.T) > 0).float()
    M = D.shape[1] ** 2 / torch.clamp(D.sum(), min=1.0) if m == 0 else m

    if use_square_clamp:
        loss = ((D * Y - 1) ** 2 + Y ** 2 / M
                + (D * T - 1) ** 2 + T ** 2 / M
                + (D * YT - 1) ** 2 + YT ** 2 / M).sum()
    else:
        loss = -((D * Y - Y / M).sum() + (D * T - T / M).sum() + (D * YT - YT / M).sum())
    return loss, {"qmi": loss}
