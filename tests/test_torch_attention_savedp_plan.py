"""The plan of #8 (``ccmh_torch.ops.attention_variants._savedp_plan``) and
how its wrapper hands it to the C entry (``csrc/attention_savedp.cu``).

The plan is made in Python and checked by the C entry, which refuses a
plan it does not compute the same way (path, the width of the copies of
probability rows into shared memory, shared-memory bytes); the CUDA side
runs only on the card, so these tests check the Python half: every shape
the kernel takes fits a block's shared memory, the bench's shapes take
the plans PERF.md records, the copy width follows the rows' alignment, and
the C entry receives the plan after bb, in its signature's order (through
a fake library).
"""

import ctypes
import math
import types

import pytest
import torch

from ccmh_torch.ops import attention_variants as av
from ccmh_torch.ops import build

SMEM_OPTIN = 232448   # shared memory a block may opt in to on an H100
ALIGNED = 1 << 20     # a start address that every copy width divides


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("Dh", [30, 64, 128])
def test_every_shape_fits_shared_memory(Dh, itemsize):
    for L in range(1, av.MAX_SEQ + 1):
        plan = av._savedp_plan(L, Dh, itemsize, ALIGNED)
        assert 0 < plan.smem_bytes <= SMEM_OPTIN, (L, plan)
        # only fp32 streams the probabilities from device memory
        assert av.SAVEDP_PATHS[plan.path] == "tiles" or itemsize == 4, (L, plan)
        # 2-byte copies only for bf16 rows of an odd length
        assert plan.width in (16, 8, 4) or (itemsize == 2 and L % 2), (L, plan)


def test_fp32_streams_only_where_the_tiles_do_not_fit():
    # four [L, Dh] operand tiles and two [L, L] tiles: fp32 fits up to
    # L = 112 at Dh = 64 and L = 80 at Dh = 128
    for Dh, last in ((64, 112), (128, 80)):
        assert av.SAVEDP_PATHS[av._savedp_plan(last, Dh, 4).path] == "tiles"
        assert av.SAVEDP_PATHS[av._savedp_plan(last + 1, Dh, 4).path] == "stream"
    assert av.SAVEDP_PATHS[av._savedp_plan(128, 128, 2).path] == "tiles"


# the bench's shapes (Dh = 64, bb = 4, the probabilities of a fresh
# allocation): (L, itemsize) -> (path, copy width, shared-memory bytes)
BENCH_PLANS = {
    (50, 2): ("tiles", 4, 55296),     # vision bf16: 100-byte rows
    (50, 4): ("tiles", 8, 104448),    # vision fp32: 200-byte rows
    (32, 2): ("tiles", 16, 23552),    # text bf16: 64-byte rows
    (32, 4): ("tiles", 16, 44032),    # text fp32: 128-byte rows
}


@pytest.mark.parametrize("L,itemsize", list(BENCH_PLANS))
def test_bench_shapes_take_the_recorded_plan(L, itemsize):
    plan = av._savedp_plan(L, 64, itemsize, ALIGNED)
    assert (av.SAVEDP_PATHS[plan.path], plan.width, plan.smem_bytes) == BENCH_PLANS[L, itemsize]


# (row bytes, the start's alignment) -> the copy width: the widest of 16,
# 8 and 4 that divides both, else a bf16 value at a time
WIDTHS = {(100, 16): 4, (100, 8): 4, (200, 16): 8, (200, 8): 8,
          (64, 16): 16, (64, 8): 8, (154, 16): 2, (154, 8): 2}


@pytest.mark.parametrize("row,align", list(WIDTHS))
def test_the_copy_width_follows_the_rows_alignment(row, align):
    itemsize = 4 if row == 200 else 2
    L = row // itemsize
    start = 3 * 4096 + align            # aligned to `align` bytes and to no more
    width = av._savedp_width(L, itemsize, start)
    assert width == WIDTHS[row, align]
    # every unit's [L, L] block and each of its rows start on a multiple
    # of the width, so one width serves the whole call
    for unit in range(7):
        for i in (0, 1, L - 1):
            assert (start + (unit * L + i) * row) % width == 0, (unit, i)
    assert av._savedp_plan(L, 64, itemsize, start).width == width


def test_vision_bf16_blocks_start_8_byte_aligned_never_16():
    """A unit's block of the vision bf16 probabilities starts (b H + h)
    5,000 bytes in: 8-byte aligned, never 16 at an odd unit, so its rows
    take 4-byte copies (a 100-byte row), not 16."""
    L, itemsize = 50, 2
    starts = [ALIGNED + u * L * L * itemsize for u in range(12)]
    assert all(s % 8 == 0 for s in starts) and any(s % 16 for s in starts)
    assert av._savedp_width(L, itemsize, ALIGNED) == 4


def test_plan_bytes(monkeypatch):
    # stream: two fp32 operand tiles and the [L, L] dS tile
    assert av._savedp_plan(128, 128, 4).smem_bytes == (2 * 128 * 132 + 128 * 132) * 4
    assert av._savedp_plan(113, 64, 4).smem_bytes == (2 * 128 * 68 + 128 * 132) * 4
    # tiles: four operand tiles and two [L, L] tiles, bf16's largest
    assert av._savedp_plan(128, 128, 2).smem_bytes == (4 + 2) * 128 * 136 * 2
    # a plan over a block's shared memory raises
    monkeypatch.setattr(av, "SMEM_OPTIN", 100_000)
    with pytest.raises(ValueError, match="shared memory"):
        av._savedp_plan(128, 128, 4)


class _FakeEntry:
    def __init__(self, code=0):
        self.restype = self.argtypes = None
        self.calls, self.code = [], code

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    def __init__(self, code=0):
        self.ccmh_attention_bwd_savedp = _FakeEntry(code)
        self.ccmh_cuda_error_string = lambda err: b"invalid argument"


def _fake(monkeypatch, code=0):
    lib = _FakeLib(code)
    loads = []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=4242))
    return lib, loads


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_the_entry_receives_the_plan_in_signature_order(dtype, code, monkeypatch):
    lib, loads = _fake(monkeypatch)
    B, L, H, Dh, bb = 8, 50, 4, 64, 4
    qkv = torch.zeros((B, L, 3 * H * Dh), dtype=dtype)
    g = torch.zeros((B, L, H * Dh), dtype=dtype)
    probs = torch.zeros((B, H, L, L), dtype=dtype)
    dqkv = torch.empty_like(qkv)
    av._launch_savedp(qkv, probs, g, dqkv, H, bb)
    assert loads == ["attention_savedp"]
    entry = lib.ccmh_attention_bwd_savedp
    assert entry.restype is ctypes.c_int
    # device, qkv, probs, g, dqkv, B, L, H, Dh, bb, path, width,
    # smem_bytes, scale, dtype, stream
    assert entry.argtypes == ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    plan = av._savedp_plan(L, Dh, qkv.element_size(), probs.data_ptr())
    assert entry.calls == [(None, qkv.data_ptr(), probs.data_ptr(), g.data_ptr(),
                            dqkv.data_ptr(), B, L, H, Dh, bb, plan.path, plan.width,
                            plan.smem_bytes, 1.0 / math.sqrt(Dh), code, 4242)]


def test_a_refused_plan_raises(monkeypatch):
    """The C entry's refusal (cudaErrorInvalidValue for a plan it does not
    compute the same way) raises in the wrapper."""
    _fake(monkeypatch, code=1)
    qkv = torch.zeros((2, 8, 3 * 32))
    with pytest.raises(RuntimeError, match="ccmh_attention_bwd_savedp: CUDA error 1"):
        av._launch_savedp(qkv, torch.zeros((2, 2, 8, 8)), torch.zeros((2, 8, 32)),
                          torch.empty_like(qkv), 2, 2)
