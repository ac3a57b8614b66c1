"""#9's tile plan (``ccmh_torch.ops.attention_variants._merged_plan``) and
how the wrapper hands it to its C entry (``csrc/attention_merged.cu``).

The plan is made in Python and checked by the C entry, which refuses a
plan whose shared-memory bytes it does not compute the same way; the CUDA
side runs only on the card, so these tests check the Python half: every
R the kernel takes fits a block's shared memory, the bench's shapes take
the paths PERF.md records, and the C entry receives the plan after bb, in
its signature's order (through a fake library).
"""

import ctypes
import math
import types

import pytest
import torch

from ccmh_torch.ops import attention_variants as av
from ccmh_torch.ops import build


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("Dh", [30, 64, 128])
def test_every_row_count_fits_shared_memory(Dh, itemsize):
    for R in range(1, av.MAX_MERGED_ROWS + 1):
        plan = av._merged_plan(R, Dh, itemsize)
        assert 0 <= plan.path < len(av.MERGED_PATHS)
        assert 0 < plan.smem_bytes <= 232448, (R, plan)
        # a warp's half of the keys in strips of 32 up to 64 rows, 64 above
        Rp = (R + 15) // 16 * 16
        assert plan.key_block == (32 if Rp <= 64 else 64)
        # only fp32 at a head dim over 64 streams its operands
        assert av.MERGED_PATHS[plan.path] != "stream" or (itemsize == 4 and Dh > 64)


# the bench's shapes (Dh = 64): vision L=50 and text L=32 at bb = 2 and 4
BENCH_PLANS = [
    # (R, itemsize, key_block, path)
    (100, 2, 64, "keep"), (100, 4, 64, "keep"),
    (200, 2, 64, "recompute"), (200, 4, 64, "recompute"),
    (64, 2, 32, "keep"), (64, 4, 32, "keep"),
    (128, 2, 64, "keep"), (128, 4, 64, "keep"),
]


@pytest.mark.parametrize("R,itemsize,key_block,path", BENCH_PLANS)
def test_bench_shapes_take_the_recorded_path(R, itemsize, key_block, path):
    plan = av._merged_plan(R, 64, itemsize)
    assert (plan.key_block, av.MERGED_PATHS[plan.path]) == (key_block, path)


def test_plan_bytes_and_overrides():
    xch = 7 * 2 * 16 * 4 * 4        # R = 100: 7 warp pairs' row-statistics exchange
    # bf16: two [112, 72] operand tiles and two [112, 120] kept tiles
    assert av._merged_plan(100, 64, 2, path="keep").smem_bytes == (
        2 * 112 * (72 + 120) * 2 + xch)
    # recomputed: the operand tiles, three fp32 row statistics and the
    # pairs' fp32 [16, 64] dq exchange
    stats = 3 * 112 * 4 + 7 * 16 * 64 * 4
    assert av._merged_plan(100, 64, 4, path="recompute").smem_bytes == (
        2 * 112 * 68 * 4 + xch + stats)
    assert av._merged_plan(100, 64, 4, path="stream").smem_bytes == stats + xch
    with pytest.raises(ValueError, match="shared"):   # [256, 256] fp32 tiles do not fit
        av._merged_plan(256, 64, 4, path="keep")
    # fp32 at R = 256, Dh = 128: two operand tiles do not fit, so they stream
    assert av.MERGED_PATHS[av._merged_plan(256, 128, 4).path] == "stream"


class _FakeEntry:
    def __init__(self, code=0):
        self.restype = self.argtypes = None
        self.calls, self.code = [], code

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    def __init__(self, code=0):
        self.ccmh_attention_bwd_merged = _FakeEntry(code)
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
    B, L, H, Dh, bb = 4, 50, 3, 64, 2
    qkv = torch.zeros((B, L, 3 * H * Dh), dtype=dtype)
    g = torch.zeros((B, L, H * Dh), dtype=dtype)
    dqkv = torch.empty_like(qkv)
    mask = av.merged_mask(None, L, bb)
    av._launch_merged(qkv, mask, g, dqkv, H, bb)
    assert loads == ["attention_merged"]
    entry = lib.ccmh_attention_bwd_merged
    assert entry.restype is ctypes.c_int
    # device, qkv, mask, g, dqkv, B, L, H, Dh, bb, key_block, path,
    # smem_bytes, scale, dtype, stream
    assert entry.argtypes == ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    plan = av._merged_plan(bb * L, Dh, qkv.element_size())
    assert entry.calls == [(None, qkv.data_ptr(), mask.data_ptr(), g.data_ptr(),
                            dqkv.data_ptr(), B, L, H, Dh, bb, plan.key_block, plan.path,
                            plan.smem_bytes, 1.0 / math.sqrt(Dh), code, 4242)]


def test_a_refused_plan_raises(monkeypatch):
    """The C entry's refusal (cudaErrorInvalidValue for a plan it does not
    compute the same way) raises in the wrapper."""
    _fake(monkeypatch, code=1)
    qkv = torch.zeros((2, 8, 3 * 32))
    with pytest.raises(RuntimeError, match="ccmh_attention_bwd_merged: CUDA error 1"):
        av._launch_merged(qkv, av.merged_mask(None, 8, 2), torch.zeros((2, 8, 32)),
                          torch.empty_like(qkv), 2, 2)
