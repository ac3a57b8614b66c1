"""Hamming distance: ±1 codes by matmul, packed codes by XOR+popcount.

Port of ``ccmh/ops/hamming.py``:

* :func:`hamming_distance` — ±1 codes, one matmul (a plain PyTorch
  product, as ``ccmh`` left it to XLA; it is not a Pallas kernel there).
* :func:`hamming_distance_packed` — packed 32-bit lanes, the XOR+popcount
  CUDA kernel ``ccmh_torch/csrc/hamming.cu`` (kernel B, replacing the
  Pallas ``_popcount_kernel``), with :func:`hamming_distance_packed_reference`
  beside it as the plain version.  The kernel masks ragged edges itself,
  so no query or gallery padding is needed.

Both return int32 distances (the true Hamming distance, no 0.5 scaling).
"""

from __future__ import annotations

import ctypes

import torch

from ccmh_torch.ops import build
from ccmh_torch.ops.packing import popcount32

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_LANES = 8   # W = ceil(K / 32) <= 8, i.e. K <= 256 bits


def hamming_distance(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """±1 codes -> Hamming distances, q [Q, K], r [N, K] -> int32 [Q, N].

    d = (K - q.r) / 2.  The dot products are small integers, exact in
    float32 (and in float16 on the card for K <= 2048, where the product
    runs at the tensor cores' half-precision rate)."""
    k = q.shape[-1]
    dtype = (torch.float16 if q.device.type == "cuda" and k <= 2048
             else torch.float32)
    dot = (q.to(dtype) @ r.to(dtype).T).to(torch.int32)
    return (k - dot) >> 1


def hamming_distance_packed_reference(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch XOR+popcount over int32 lanes -> int32 [Q, N]
    (one [Q, N] pass per lane, so the temporaries stay [Q, N])."""
    out = torch.zeros((q.shape[0], r.shape[0]), dtype=torch.int32, device=q.device)
    for w in range(q.shape[1]):
        out += popcount32(q[:, w, None] ^ r[None, :, w])
    return out


def _kernel_fn():
    lib = build.load("hamming")
    fn = lib.ccmh_hamming_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def hamming_distance_packed(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Packed int32 lanes q [Q, W], r [N, W] -> int32 distances [Q, N].

    A CPU tensor takes :func:`hamming_distance_packed_reference`; a CUDA
    tensor launches the kernel on PyTorch's current stream, or raises."""
    global launches
    if q.ndim != 2 or r.ndim != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"q [Q, W] and r [N, W] must share W, got "
                         f"{list(q.shape)} and {list(r.shape)}")
    if q.dtype != torch.int32 or r.dtype != torch.int32:
        raise TypeError(f"packed lanes are int32, got {q.dtype} and {r.dtype}")
    if q.device != r.device:
        raise ValueError(f"q is on {q.device}, r on {r.device}")
    if q.device.type == "cpu":
        return hamming_distance_packed_reference(q, r)
    if q.device.type != "cuda":
        raise ValueError(f"hamming_distance_packed runs on cuda or cpu, got {q.device}")
    Q, W = q.shape
    N = r.shape[0]
    if not 1 <= W <= MAX_LANES:
        raise ValueError(f"the popcount kernel takes 1 <= W <= {MAX_LANES}, got {W}")
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("q and r must be contiguous")
    out = torch.empty((Q, N), dtype=torch.int32, device=q.device)
    if Q == 0 or N == 0:
        return out
    lib, fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.device.index, q.data_ptr(), r.data_ptr(), out.data_ptr(), Q, N, W, stream)
    build.raise_on_error(lib, "ccmh_hamming_packed", err)
    launches += 1
    return out
