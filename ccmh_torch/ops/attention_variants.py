"""The attention ablation variants of ``tools/bench_attn_bwd.py``: five
kernels, each a wrapper with a plain PyTorch version beside it.

Port of the five Pallas kernels of ``tools/bench_attn_bwd.py`` as CUDA C++
for Hopper: ``backward_x`` (#6, eight ablation ``mode``\\ s of the
attention backward at a forced batch block) and ``backward_headpair``
(#10, two heads a program) as ``ccmh_torch/csrc/attention_bwd_x.cu``;
``backward_savedp`` (#8, the backward from saved probabilities) as
``ccmh_torch/csrc/attention_savedp.cu``; ``backward_merged`` (#9, bb
batch elements as merged rows under a block-diagonal mask) as
``ccmh_torch/csrc/attention_merged.cu``; ``forward_stacked`` (#7, the
forward with all heads' logits stacked before one softmax) as
``ccmh_torch/csrc/attention_fwd_stacked.cu``.  All five run on the
tensor cores; the plans of #6/#10 (:func:`_bwd_x_plan`), #8
(:func:`_savedp_plan`) and #9 (:func:`_merged_plan`) are made here and
checked by their C entries.  Each
computes kernel #2's (or #1's) function with no projection bias, apart
from the changes its ``mode`` makes (``*_reference`` spell each out step
by step after the Pallas bodies).  ``savedp_probs`` and ``merged_mask``
build the setup inputs that the TPU tool builds outside its
``pallas_call``\\ s, and stay plain PyTorch.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Every wrapper counts its launches.  One departure from the TPU
tool, on both devices: its grids are ``B // bb`` and leave the trailing
rows of a B that bb does not divide unwritten; here such a B raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ccmh_torch.ops import build
from ccmh_torch.ops.attention import attention_reference

# launches of the CUDA kernels since the counts were last set to 0
backward_x_launches = 0          # #6
forward_stacked_launches = 0     # #7
backward_savedp_launches = 0     # #8
backward_merged_launches = 0     # #9
backward_headpair_launches = 0   # #10

# #6's modes, in the order of their codes in csrc/attention_bwd_x.cu
MODES = ("full", "stacked", "pair", "nomax", "nosoftmax", "novjp", "bf16vjp", "fewstores")
# the modes that compute kernel #2's function (nomax: other rounding)
SAME_FUNCTION_MODES = ("full", "stacked", "pair", "nomax")
MAX_SEQ = 128          # keys a unit takes (#6, #8, #10: 8 16-key tiles)
MAX_MERGED_ROWS = 256  # #9: R = bb L
MAX_HEAD_DIM = 128
SMEM_OPTIN = 232448    # shared memory a block may take on an H100 (bytes)
OFF_BLOCK = -1e9       # #9's mask between batch elements
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions

def _heads(qkv: torch.Tensor, n_head: int):
    """q, k, v of [N, R, 3D] as fp32 [N, R, H, Dh] each."""
    N, R, D3 = qkv.shape
    return qkv.reshape(N, R, 3, n_head, D3 // 3 // n_head).float().unbind(2)


def _backward(qkv, logits, g, n_head, mode="full", probs_c=None):
    """The Pallas bodies' backward from fp32 ``logits`` [N, H, R, R] (or,
    for #8, the rounded ``probs_c``), ``qkv`` [N, R, 3D] and ``g``
    [N, R, D] in qkv's type -> dqkv [N, R, 3D]."""
    N, R, D3 = qkv.shape
    D = D3 // 3
    head_dim = D // n_head
    scale = 1.0 / math.sqrt(head_dim)
    dtype = qkv.dtype
    q, k, v = _heads(qkv, n_head)
    g = g.to(dtype).reshape(N, R, n_head, head_dim).float()
    if probs_c is not None:                       # #8: the saved, rounded probs
        probs = probs_c.float()
    elif mode == "nomax":
        e = torch.exp(logits)
        probs = e / e.sum(-1, keepdim=True)
    elif mode == "nosoftmax":
        probs = logits * 0.01
    else:
        probs = torch.softmax(logits, dim=-1)
    dprobs = torch.einsum("bqhd,bkhd->bhqk", g, v)
    if mode == "novjp":
        dlogits_c = (dprobs * scale).to(dtype).float()
    elif mode == "bf16vjp":
        # the chain in the input type, each op rounded to it; scale is a
        # scalar of that type
        p16, dp16 = probs.to(dtype), dprobs.to(dtype)
        dlogits = p16 * (dp16 - (dp16 * p16).sum(-1, keepdim=True).to(dtype))
        dlogits_c = (dlogits * torch.tensor(scale, dtype=dtype)).to(dtype).float()
    else:
        dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
        dlogits_c = (dlogits * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits_c, k)
    if mode == "fewstores":
        out = torch.empty_like(qkv)
        out[:, :, D:2 * D] = dq.reshape(N, R, D).to(dtype)
        return out
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits_c, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(dtype).float(), g)
    return torch.stack([dq, dk, dv], dim=2).to(dtype).reshape(N, R, D3)


def _logits(qkv, bias, n_head):
    q, k, _ = _heads(qkv, n_head)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    return logits if bias is None else logits + bias.float()


def backward_x_reference(qkv: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
                         n_head: int, mode: str = "full") -> torch.Tensor:
    """Plain #6, ``_bwd_kernel_x`` step by step: ``full``, ``stacked`` and
    ``pair`` are kernel #2's backward with no projection bias (the schedule
    is all that differs); ``nomax`` drops the max from the softmax,
    ``nosoftmax`` takes ``probs = logits * 0.01``, ``novjp`` takes
    ``dlogits = dprobs``, ``bf16vjp`` runs the softmax VJP in the input
    type, and ``fewstores`` writes only dq, into the dk slot, and leaves the
    q and v slots uninitialised (``torch.empty``)."""
    _check_mode(mode, n_head)
    return _backward(qkv, _logits(qkv, bias, n_head), g, n_head, mode)


def forward_stacked_reference(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                              n_head: int) -> torch.Tensor:
    """Plain #7: kernel #1's forward with no projection bias (stacking the
    heads' logits before the softmax changes the schedule only)."""
    return attention_reference(qkv, bias, n_head)


def savedp_probs(qkv: torch.Tensor, bias: Optional[torch.Tensor], n_head: int) -> torch.Tensor:
    """#8's setup input: the fp32 logits plus ``bias``, softmax, rounded to
    qkv's type -> [B, H, L, L]."""
    return torch.softmax(_logits(qkv, bias, n_head), dim=-1).to(qkv.dtype)


def backward_savedp_reference(qkv: torch.Tensor, probs: torch.Tensor, g: torch.Tensor,
                              n_head: int) -> torch.Tensor:
    """Plain #8, ``_bwd_kernel_savedp``: the backward with the fp32 value
    of the saved, rounded ``probs`` [B, H, L, L] in place of the recomputed
    softmax (no mask is read)."""
    return _backward(qkv, None, g, n_head, probs_c=probs)


def merged_mask(bias: Optional[torch.Tensor], L: int, bb: int,
                device="cpu") -> torch.Tensor:
    """#9's setup input: the fp32 [R, R] mask of R = bb L merged rows,
    ``bias`` (or 0) in each of the bb diagonal [L, L] blocks and -1e9
    between batch elements.  On ``bias``'s device when there is one."""
    if bias is not None:
        device = bias.device
    R = bb * L
    mask = torch.full((R, R), OFF_BLOCK, dtype=torch.float32, device=device)
    blk = torch.zeros((L, L), device=device) if bias is None else bias.float()
    for i in range(bb):
        mask[i * L:(i + 1) * L, i * L:(i + 1) * L] = blk
    return mask


def backward_merged_reference(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                              n_head: int, bb: int) -> torch.Tensor:
    """Plain #9, ``_bwd_kernel_merged``: the backward over R = bb L merged
    rows with the [R, R] ``mask`` added to every head's logits.  Off-block
    probabilities are exactly 0, so it is kernel #2's function, at bb-fold
    operations."""
    B, L, D3 = qkv.shape
    R = bb * L
    merged = qkv.reshape(B // bb, R, D3)
    out = _backward(merged, _logits(merged, mask, n_head), g.reshape(B // bb, R, D3 // 3),
                    n_head)
    return out.reshape(B, L, D3)


def backward_headpair_reference(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                                g: torch.Tensor, n_head: int) -> torch.Tensor:
    """Plain #10, ``_bwd_kernel_headpair``: kernel #2's backward with no
    projection bias (two heads a program is the schedule); H even."""
    _check_mode("pair", n_head)
    return _backward(qkv, _logits(qkv, bias, n_head), g, n_head)


# ------------------------------------------------------------ #9's tile plan

# #9's ways through phase B: P_c and dS_c recomputed from row statistics,
# kept in shared memory from phase A, or recomputed with both operands read
# from device memory (where the two [R, Dh] operand tiles and the dq
# buffers do not fit shared memory)
MERGED_PATHS = ("recompute", "keep", "stream")


class MergedPlan(NamedTuple):
    """How ``csrc/attention_merged.cu`` runs R merged rows, in its C entry's
    argument order: ``key_block``, the register class (the most keys of a
    16-row tile one warp holds: a group of 2 warps shares a tile's keys up
    to 128 rows, of 4 above, so 32 up to 64 rows and 64 above), ``path``
    (an index into :data:`MERGED_PATHS`) and the block's shared-memory
    bytes."""
    key_block: int
    path: int
    smem_bytes: int


MERGED_MAX_WARPS = 16  # a block's warps: groups of 2 (4 above 128 rows) a 16-row tile


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def _tile_ld(cols: int, itemsize: int) -> int:
    """Row stride (elements) of a shared-memory tile: mma_tiles.cuh tile_ld."""
    return _pad16(cols) + (8 if itemsize == 2 else 4)


def _merged_smem(R: int, Dh: int, itemsize: int, path: str) -> int:
    """The block's shared-memory bytes (attention_merged.cu plan_smem)."""
    Rp = _pad16(R)
    group = 2 if Rp <= 128 else 4
    warps = group * min(Rp // 16, MERGED_MAX_WARPS // group)
    xch = warps * 16 * 4 * 4                # each warp's row statistics, for its group
    # the rows' max, sum and sum_j dP P, and the groups' [16, Dh] dq buffers
    stats = 3 * Rp * 4 + warps // 2 * 16 * _pad16(Dh) * 4
    if path == "stream":
        return stats + xch
    operands = 2 * Rp * _tile_ld(Dh, itemsize) * itemsize
    if path == "keep":
        return operands + xch + 2 * Rp * _tile_ld(R, itemsize) * itemsize
    return operands + xch + stats


def _merged_plan(R: int, Dh: int, itemsize: int, smem_optin: int = SMEM_OPTIN,
                 path: Optional[str] = None) -> MergedPlan:
    """#9's plan for R merged rows of head dim Dh in a type of ``itemsize``
    bytes: the [R, R] tiles kept where they fit ``smem_optin``, else
    recomputed, else (fp32 from 145 rows at a head dim over 80) both
    operands streamed from device memory.  ``path`` overrides the rule (for timing the
    others); a plan that does not fit raises."""
    if path is None:
        path = next(p for p in ("keep", "recompute", "stream")
                    if _merged_smem(R, Dh, itemsize, p) <= smem_optin)
    smem = _merged_smem(R, Dh, itemsize, path)
    if smem > smem_optin:
        raise ValueError(f"#9's {path} plan for R={R}, Dh={Dh} takes {smem} bytes of shared "
                         f"memory, over {smem_optin}")
    return MergedPlan(32 if _pad16(R) <= 64 else 64, MERGED_PATHS.index(path), smem)


# ------------------------------------------------------------ #6's and #10's plan

# the ways through csrc/attention_bwd_x.cu: the four operand tiles and the
# two [L, L] tiles in shared memory, or (fp32 where they do not fit) two
# operand tiles at a time with the probabilities recomputed key-major
BWD_X_PATHS = ("tiles", "recompute")
BWD_X_MAX_GROUPS = 4
# Measured choices (tools/time_torch_attention.py --bwd-x-plans, PERF.md
# §6) by (item size, warps a unit = pad16(L) / 16), where L and Dh
# are at most 64 (one warp group a block otherwise): the warp groups of a
# `pair` or #10 block (1: one head after the other; 2: both heads at once;
# 4: two elements' head pairs), and the most steps a `stacked` block walks
# (it works on E = ceil(bb / steps) elements at once; None: one element at
# a time).  The four keys are the bench's shapes (vision and text, bf16 and
# fp32); every other shape takes BWD_X_DEFAULT, one group and four steps,
# which no run has timed (a guess that keeps stacked's steps bounded).
BWD_X_TUNED = {(2, 2): (4, 2), (2, 4): (1, None), (4, 2): (2, 4), (4, 4): (2, 4)}
BWD_X_DEFAULT = (1, 4)


class BwdXPlan(NamedTuple):
    """How ``csrc/attention_bwd_x.cu`` runs #6 or #10, in its C entries'
    argument order after ``mode``: ``path`` (an index into
    :data:`BWD_X_PATHS`), ``groups`` (warp groups a block, each on its own
    (element, head) unit at a time) and the block's shared-memory bytes.  A
    block covers two heads in ``pair`` and #10, one otherwise."""
    path: int
    groups: int
    smem_bytes: int


def _bwd_x_smem(L: int, Dh: int, itemsize: int, path: str, groups: int, mode: str) -> int:
    """The block's shared-memory bytes (attention_bwd_x.cu tiles_smem,
    recompute_smem)."""
    Lp = _pad16(L)
    if path == "recompute":
        return (2 * Lp * _tile_ld(Dh, 4) + 3 * Lp) * 4
    tiles = 0 if mode == "fewstores" else 2 * Lp * _tile_ld(L, itemsize)
    return groups * (4 * Lp * _tile_ld(Dh, itemsize) + tiles) * itemsize


def _bwd_x_plan(mode: str, L: int, Dh: int, itemsize: int, bb: int = 1,
                groups: Optional[int] = None, path: Optional[str] = None,
                smem_optin: int = SMEM_OPTIN) -> BwdXPlan:
    """#6's plan for ``mode`` (or #10's, ``mode="headpair"``) at L keys,
    head dim Dh and a batch block of ``bb``, in a type of ``itemsize``
    bytes: where L and Dh are at most 64, the warp groups of
    :data:`BWD_X_TUNED` for ``pair`` and #10, and for ``stacked`` the
    elements its steps call for (at most 4 warp groups, fewer where they do
    not fit); the tile path where its tiles fit ``smem_optin``, else (fp32)
    the recompute path.  ``groups`` and ``path`` override the rules (for
    timing the others); a plan that does not fit raises."""
    small = _pad16(L) <= 64 and _pad16(Dh) <= 64
    pair_groups, steps = BWD_X_TUNED.get((itemsize, _pad16(L) // 16), BWD_X_DEFAULT)
    if groups is None:
        groups = 1
        if small and mode in ("pair", "headpair"):
            groups = pair_groups
        elif small and mode == "stacked" and steps is not None:
            groups = min(-(-bb // steps), BWD_X_MAX_GROUPS)
        while groups > 1 and _bwd_x_smem(L, Dh, itemsize, "tiles", groups, mode) > smem_optin:
            groups = groups // 2 if mode != "stacked" else groups - 1
    if path is None:
        fits = _bwd_x_smem(L, Dh, itemsize, "tiles", groups, mode) <= smem_optin
        path = "tiles" if fits or itemsize != 4 or groups > 1 else "recompute"
    smem = _bwd_x_smem(L, Dh, itemsize, path, groups, mode)
    if smem > smem_optin:
        raise ValueError(f"#6's {path} plan for {mode} at L={L}, Dh={Dh} with {groups} warp "
                         f"groups takes {smem} bytes of shared memory, over {smem_optin}")
    return BwdXPlan(BWD_X_PATHS.index(path), groups, smem)


def _bwd_x_entry(mode: str, L: int, Dh: int, itemsize: int, bb: int,
                 plan: Optional[BwdXPlan] = None):
    """(library, C entry, its int arguments after B, L, H, Dh) of #6 in
    ``mode``, or of #10 for ``mode="headpair"``: bb, #6's mode code, then
    ``plan`` (default :func:`_bwd_x_plan`'s)."""
    if plan is None:
        plan = _bwd_x_plan(mode, L, Dh, itemsize, bb)
    if mode == "headpair":
        return "attention_bwd_x", "ccmh_attention_bwd_headpair", (bb, *plan)
    return "attention_bwd_x", "ccmh_attention_bwd_x", (bb, MODES.index(mode), *plan)


# ------------------------------------------------------------ #8's plan

# the ways through csrc/attention_savedp.cu: the four operand tiles and the
# two [L, L] tiles (the saved probabilities and dS) in shared memory, or
# (fp32 where they do not fit) two operand tiles at a time and the dS tile,
# the probabilities' fragments read from device memory
SAVEDP_PATHS = ("tiles", "stream")


class SavedpPlan(NamedTuple):
    """How ``csrc/attention_savedp.cu`` runs #8, in its C entry's argument
    order after bb: ``path`` (an index into :data:`SAVEDP_PATHS`),
    ``width`` (the bytes of each copy of probability rows into shared
    memory: 16, 8 or 4 by ``cp.async``, 2 by scalar copies of bf16) and the
    block's shared-memory bytes."""
    path: int
    width: int
    smem_bytes: int


def _savedp_smem(L: int, Dh: int, itemsize: int, path: str) -> int:
    """The block's shared-memory bytes (attention_savedp.cu tiles_smem,
    stream_smem)."""
    Lp = _pad16(L)
    if path == "stream":
        return (2 * Lp * _tile_ld(Dh, 4) + Lp * _tile_ld(L, 4)) * 4
    return (4 * Lp * _tile_ld(Dh, itemsize) + 2 * Lp * _tile_ld(L, itemsize)) * itemsize


def _savedp_width(L: int, itemsize: int, probs_ptr: int) -> int:
    """The widest copy (bytes) that divides both the probabilities' start
    address and a row of L values, 16, 8 or 4, else (bf16) 2: every unit's
    [L, L] block starts a whole number of rows in, so each of its rows
    takes the same copies (attention_savedp.cu probs_width)."""
    return next((w for w in (16, 8, 4) if (L * itemsize) % w == 0 and probs_ptr % w == 0),
                itemsize)


def _savedp_plan(L: int, Dh: int, itemsize: int, probs_ptr: int = 0) -> SavedpPlan:
    """#8's plan at L keys and head dim Dh in a type of ``itemsize`` bytes,
    its probabilities starting at address ``probs_ptr``: the tile path
    where its tiles fit a block's shared memory (always in bf16), else
    (fp32 from L = 113 at Dh = 64, from L = 81 at Dh = 128) the stream
    path.  A plan that does not fit raises."""
    path = "tiles"
    if itemsize == 4 and _savedp_smem(L, Dh, itemsize, path) > SMEM_OPTIN:
        path = "stream"
    smem = _savedp_smem(L, Dh, itemsize, path)
    if smem > SMEM_OPTIN:
        raise ValueError(f"#8's {path} plan for L={L}, Dh={Dh} takes {smem} bytes of shared "
                         f"memory, over {SMEM_OPTIN}")
    return SavedpPlan(SAVEDP_PATHS.index(path), _savedp_width(L, itemsize, probs_ptr), smem)


def _savedp_entry(L: int, Dh: int, itemsize: int, bb: int, probs_ptr: int,
                  plan: Optional[SavedpPlan] = None):
    """(library, C entry, its int arguments after B, L, H, Dh) of #8: bb,
    then ``plan`` (default :func:`_savedp_plan`'s for probabilities at
    ``probs_ptr``)."""
    if plan is None:
        plan = _savedp_plan(L, Dh, itemsize, probs_ptr)
    return "attention_savedp", "ccmh_attention_bwd_savedp", (bb, *plan)


# ------------------------------------------------------------ checks

def _check_mode(mode: str, n_head: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "pair" and n_head % 2:
        raise ValueError(f"two heads a block needs an even head count, got {n_head}")


def _check(qkv, bias, g, n_head, bb, what) -> None:
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [B, L, 3D], got {list(qkv.shape)}")
    B, L, D3 = qkv.shape
    if n_head < 1 or (D3 // 3) % n_head:
        raise ValueError(f"D={D3 // 3} is not divisible by n_head={n_head}")
    if bias is not None and tuple(bias.shape) != (L, L):
        raise ValueError(f"bias must be [L, L] = [{L}, {L}], got {list(bias.shape)}")
    if g is not None and tuple(g.shape) != (B, L, D3 // 3):
        raise ValueError(f"g must be [{B}, {L}, {D3 // 3}], got {list(g.shape)}")
    if bb < 1 or B % bb:
        # the TPU grid B // bb would leave the trailing rows unwritten
        raise ValueError(f"{what}: bb={bb} must divide B={B}")
    for name, t in (("bias", bias), ("g", g)):
        if t is not None and t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {qkv.device}")


def _check_kernel(qkv, n_head, what, max_rows=MAX_SEQ, rows=None, fp32=()) -> None:
    B, L, D3 = qkv.shape
    head_dim = D3 // 3 // n_head
    rows = L if rows is None else rows
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {qkv.dtype}")
    if not 1 <= rows <= max_rows or not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{what} takes at most {max_rows} rows a block and a head dim of "
                         f"at most {MAX_HEAD_DIM} (got {rows} and {head_dim})")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    for name, t in fp32:
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32, got {t.dtype}")


# ------------------------------------------------------------ the kernels

def _entry(lib_name: str, name: str, n_ptrs: int, n_ints: int):
    lib = build.load(lib_name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(lib_name, name, qkv, ptrs, ints, n_head):
    B, L, D3 = qkv.shape
    head_dim = D3 // 3 // n_head
    lib, fn = _entry(lib_name, name, len(ptrs), 4 + len(ints))
    err = fn(qkv.device.index, *(_ptr(p) for p in ptrs), B, L, n_head, head_dim, *ints,
             1.0 / math.sqrt(head_dim), _DTYPE_CODES[qkv.dtype],
             torch.cuda.current_stream(qkv.device).cuda_stream)
    build.raise_on_error(lib, name, err)


def _g(g, qkv):
    """The cotangent in qkv's type (as the TPU tool casts it), contiguous."""
    return g.to(qkv.dtype).contiguous()


def backward_x(qkv: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
               n_head: int, bb: int, mode: str) -> torch.Tensor:
    """#6: the attention backward of ``qkv`` [B, L, 3D] for the cotangent
    ``g`` [B, L, D] under the fp32 [L, L] ``bias`` (or None), a block
    walking ``bb`` batch elements, in one of :data:`MODES` (see
    :func:`backward_x_reference`) -> dqkv [B, L, 3D] in qkv's type.  The
    kernel runs :func:`_bwd_x_plan`'s plan, which it checks."""
    global backward_x_launches
    _check(qkv, bias, g, n_head, bb, "backward_x")
    _check_mode(mode, n_head)
    if qkv.device.type == "cpu":
        return backward_x_reference(qkv, bias, g, n_head, mode)
    _check_kernel(qkv, n_head, "backward_x", fp32=(("bias", bias),))
    g = _g(g, qkv)
    dqkv = torch.empty_like(qkv)
    _launch_bwd_x(qkv, bias, g, dqkv, n_head, bb, mode)
    backward_x_launches += 1
    return dqkv


def _launch_bwd_x(qkv, bias, g, dqkv, n_head, bb, mode) -> None:
    """#6's C entry (or #10's, ``mode="headpair"``), as :func:`_bwd_x_entry`
    gives it."""
    lib, name, ints = _bwd_x_entry(mode, qkv.shape[1], qkv.shape[2] // 3 // n_head,
                                   qkv.element_size(), bb)
    _launch(lib, name, qkv, (qkv, bias, g, dqkv), ints, n_head)


def forward_stacked(qkv: torch.Tensor, bias: Optional[torch.Tensor], n_head: int,
                    bb: int) -> torch.Tensor:
    """#7: the attention forward of ``qkv`` [B, L, 3D] under ``bias``, all
    heads' logits stacked before one softmax, a block walking ``bb`` batch
    elements -> [B, L, D] in qkv's type."""
    global forward_stacked_launches
    _check(qkv, bias, None, n_head, bb, "forward_stacked")
    if qkv.device.type == "cpu":
        return forward_stacked_reference(qkv, bias, n_head)
    _check_kernel(qkv, n_head, "forward_stacked", fp32=(("bias", bias),))
    B, L, D3 = qkv.shape
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    _launch("attention_fwd_stacked", "ccmh_attention_fwd_stacked", qkv, (qkv, bias, out),
            (bb,), n_head)
    forward_stacked_launches += 1
    return out


def backward_savedp(qkv: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
                    n_head: int, bb: int,
                    probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#8: the backward from saved probabilities.  ``probs`` [B, H, L, L]
    in qkv's type is :func:`savedp_probs` of ``qkv`` and ``bias``, built
    here when not given (a caller timing the kernel builds it once, as the
    TPU tool's jit hoists it out of its loop); the kernel reads no mask
    and runs :func:`_savedp_plan`'s plan, which it checks."""
    global backward_savedp_launches
    _check(qkv, bias, g, n_head, bb, "backward_savedp")
    if probs is None:
        probs = savedp_probs(qkv, bias, n_head)
    B, L, _ = qkv.shape
    if tuple(probs.shape) != (B, n_head, L, L) or probs.dtype != qkv.dtype:
        raise ValueError(f"probs must be [{B}, {n_head}, {L}, {L}] {qkv.dtype}, got "
                         f"{list(probs.shape)} {probs.dtype}")
    if qkv.device.type == "cpu":
        return backward_savedp_reference(qkv, probs, g, n_head)
    _check_kernel(qkv, n_head, "backward_savedp")
    if not probs.is_contiguous() or probs.device != qkv.device:
        raise ValueError("probs must be contiguous, on qkv's device")
    g = _g(g, qkv)
    dqkv = torch.empty_like(qkv)
    _launch_savedp(qkv, probs, g, dqkv, n_head, bb)
    backward_savedp_launches += 1
    return dqkv


def _launch_savedp(qkv, probs, g, dqkv, n_head, bb) -> None:
    """#8's C entry, as :func:`_savedp_entry` gives it for ``probs``."""
    lib, name, ints = _savedp_entry(qkv.shape[1], qkv.shape[2] // 3 // n_head,
                                    qkv.element_size(), bb, probs.data_ptr())
    _launch(lib, name, qkv, (qkv, probs, g, dqkv), ints, n_head)


def backward_merged(qkv: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
                    n_head: int, bb: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#9: the backward over R = bb L merged rows under ``mask`` [R, R],
    :func:`merged_mask` of ``bias``, built here when not given (a caller
    timing the kernel builds it once, as the TPU tool builds it at trace
    time).  The kernel takes R <= 256 and runs :func:`_merged_plan`'s
    plan, which it checks."""
    global backward_merged_launches
    _check(qkv, bias, g, n_head, bb, "backward_merged")
    B, L, _ = qkv.shape
    if mask is None:
        mask = merged_mask(bias, L, bb, device=qkv.device)
    if tuple(mask.shape) != (bb * L, bb * L) or mask.device != qkv.device:
        raise ValueError(f"mask must be [{bb * L}, {bb * L}] on qkv's device, got "
                         f"{list(mask.shape)} on {mask.device}")
    if qkv.device.type == "cpu":
        return backward_merged_reference(qkv, mask, g, n_head, bb)
    _check_kernel(qkv, n_head, "backward_merged", max_rows=MAX_MERGED_ROWS, rows=bb * L,
                  fp32=(("mask", mask),))
    g = _g(g, qkv)
    dqkv = torch.empty_like(qkv)
    _launch_merged(qkv, mask, g, dqkv, n_head, bb)
    backward_merged_launches += 1
    return dqkv


def _launch_merged(qkv, mask, g, dqkv, n_head, bb) -> None:
    """#9's C entry with :func:`_merged_plan`'s plan after bb."""
    B, L, D3 = qkv.shape
    plan = _merged_plan(bb * L, D3 // 3 // n_head, qkv.element_size())
    _launch("attention_merged", "ccmh_attention_bwd_merged", qkv, (qkv, mask, g, dqkv),
            (bb, *plan), n_head)


def backward_headpair(qkv: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
                      n_head: int, bb: int) -> torch.Tensor:
    """#10: the backward on a (B / bb, H / 2) grid, two heads a block
    (``qkv`` seen as [B, L, 3, H, Dh], the same memory); H even.  The
    kernel runs :func:`_bwd_x_plan`'s plan for ``"headpair"``."""
    global backward_headpair_launches
    _check(qkv, bias, g, n_head, bb, "backward_headpair")
    _check_mode("pair", n_head)
    if qkv.device.type == "cpu":
        return backward_headpair_reference(qkv, bias, g, n_head)
    _check_kernel(qkv, n_head, "backward_headpair", fp32=(("bias", bias),))
    g = _g(g, qkv)
    dqkv = torch.empty_like(qkv)
    _launch_bwd_x(qkv, bias, g, dqkv, n_head, bb, "headpair")
    backward_headpair_launches += 1
    return dqkv
