"""Binary code packing: float/±1 codes <-> packed 32-bit lanes.

Port of ``ccmh/ops/packing.py``.  Two representations of a code matrix:

* ±1 int8 [N, K]   — the matmul form of Hamming ranking.
* packed [N, ceil(K/32)] — 32 bits per lane for million-item galleries
  and the XOR+popcount kernel (ccmh_torch/csrc/hamming.cu).

PyTorch supports few operations on uint32, so the packed lanes are int32
tensors holding the SAME bit patterns as ``ccmh``'s uint32 lanes: bit b
of lane w is set iff code[:, 32*w + b] is positive, and bit 31 lands in
the int32 sign bit.  ``tensor.numpy().view(np.uint32)`` gives ``ccmh``'s
lanes bit for bit.
"""

from __future__ import annotations

import torch


def sign_codes(x: torch.Tensor) -> torch.Tensor:
    """Binarize relaxed codes to ±1 int8 (0 maps to +1, as in ``ccmh``)."""
    return torch.where(x >= 0, 1, -1).to(torch.int8)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """[N, K] ±1 (or float-signed) -> [N, ceil(K/32)] int32 bit patterns.

    K is zero-padded to a multiple of 32; padded bits are 0 on both sides of
    a XOR so they never affect Hamming distances.  The lanes are built by
    OR-ing shifted bits in int32: ``1 << 31`` is the int32 sign bit, so no
    sum ever overflows.
    """
    n, k = codes.shape
    w = -(-k // 32)
    bits = (codes > 0).to(torch.int32)
    bits = torch.nn.functional.pad(bits, (0, w * 32 - k)).reshape(n, w, 32)
    shifted = bits << torch.arange(32, dtype=torch.int32, device=codes.device)
    out = torch.zeros((n, w), dtype=torch.int32, device=codes.device)
    for b in range(32):
        out |= shifted[:, :, b]
    return out


def unpack_codes(packed: torch.Tensor, k: int) -> torch.Tensor:
    """[N, W] int32 lanes -> [N, K] ±1 int8 (inverse of pack_codes)."""
    n, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1          # arithmetic shift, & 1
    bits = bits.reshape(n, w * 32)[:, :k]
    return (2 * bits - 1).to(torch.int8)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of each int32 lane's 32-bit pattern (SWAR), in int32.

    PyTorch's ``>>`` on int32 is arithmetic, so a negative lane shifts its
    sign bit in from the top.  Each step masks those bits away (the masks
    clear bit 31), and from the second step on every field is a small
    count, so the value is non-negative and the shifts are logical.  The
    bytes are summed with shifts instead of ``* 0x01010101``, which would
    overflow int32."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x55555555)                 # 2-bit counts (wraps like uint32)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)  # 4-bit counts, x >= 0 from here
    x = (x + (x >> 4)) & 0x0F0F0F0F                 # byte counts
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F
