"""The plan of #6 and #10 (``ccmh_torch.ops.attention_variants._bwd_x_plan``)
and how their wrappers hand it to the C entries (``csrc/attention_bwd_x.cu``).

The plan is made in Python and checked by the C entry, which refuses a
plan whose shared-memory bytes it does not compute the same way; the CUDA
side runs only on the card, so these tests check the Python half: every
shape the kernels take fits a block's shared memory, the bench's shapes
take the plans PERF.md records, and the C entries receive the plan after
bb (and #6's mode), in their signatures' order (through a fake library).
"""

import ctypes
import math
import types

import pytest
import torch

from ccmh_torch.ops import attention_variants as av
from ccmh_torch.ops import build

PLAN_MODES = av.MODES + ("headpair",)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("Dh", [30, 64, 128])
def test_every_shape_fits_shared_memory(Dh, itemsize):
    for mode in PLAN_MODES:
        for L in range(1, av.MAX_SEQ + 1):
            for bb in (1, 4, 8):
                plan = av._bwd_x_plan(mode, L, Dh, itemsize, bb)
                assert 0 < plan.smem_bytes <= 232448, (mode, L, bb, plan)
                path = av.BWD_X_PATHS[plan.path]
                # only fp32 recomputes, one unit a block
                assert path == "tiles" or (itemsize == 4 and plan.groups == 1), (mode, L, plan)
                assert 1 <= plan.groups <= av.BWD_X_MAX_GROUPS, (mode, L, plan)
                # several warp groups only at L, Dh <= 64, for the modes of
                # #2's function
                assert plan.groups == 1 or (
                    (L + 15) // 16 * 16 <= 64 and Dh <= 64
                    and mode in ("full", "stacked", "pair", "headpair")), (mode, L, plan)


def test_fp32_recomputes_only_where_the_tiles_do_not_fit():
    # four [L, Dh] operand tiles and two [L, L] tiles: fp32 fits up to
    # L = 112 at Dh = 64 and L = 80 at Dh = 128
    for Dh, last in ((64, 112), (128, 80)):
        assert av.BWD_X_PATHS[av._bwd_x_plan("full", last, Dh, 4).path] == "tiles"
        assert av.BWD_X_PATHS[av._bwd_x_plan("full", last + 1, Dh, 4).path] == "recompute"
    assert av.BWD_X_PATHS[av._bwd_x_plan("full", 128, 128, 2).path] == "tiles"


# the bench's shapes (Dh = 64): vision L=50 H=12 and text L=32 H=8, bb=4
# (stacked also at bb=8): (mode, L, H, itemsize, bb) -> warp groups
SINGLE = ("full", "nomax", "nosoftmax", "novjp", "bf16vjp", "fewstores")
PAIR_GROUPS = {(50, 2): 1, (32, 2): 4, (50, 4): 2, (32, 4): 2}
STACKED_GROUPS = {(50, 2, 4): 1, (50, 2, 8): 1, (32, 2, 4): 2, (32, 2, 8): 4,
                  (50, 4, 4): 1, (50, 4, 8): 2, (32, 4, 4): 1, (32, 4, 8): 2}
BENCH_PLANS = [
    *[(m, L, H, it, 4, 1) for m in SINGLE for L, H in ((50, 12), (32, 8))
      for it in (2, 4)],
    *[(m, L, H, it, 4, PAIR_GROUPS[L, it]) for m in ("pair", "headpair")
      for L, H in ((50, 12), (32, 8)) for it in (2, 4)],
    *[("stacked", L, H, it, bb, STACKED_GROUPS[L, it, bb])
      for L, H in ((50, 12), (32, 8)) for it in (2, 4) for bb in (4, 8)],
]


@pytest.mark.parametrize("mode,L,H,itemsize,bb,want", BENCH_PLANS)
def test_bench_shapes_take_the_recorded_plan(mode, L, H, itemsize, bb, want):
    plan = av._bwd_x_plan(mode, L, 64, itemsize, bb)
    assert av.BWD_X_PATHS[plan.path] == "tiles"
    assert plan.groups == want


@pytest.mark.parametrize("bb", [1, 2, 4, 8, 16])
def test_a_stacked_block_walks_no_more_steps_as_bb_grows(bb):
    """stacked works on E = ceil(bb / steps) elements of one head at once,
    a warp group each (BWD_X_TUNED's steps; one element where it names
    none), as far as 4 warp groups and shared memory allow, so that where
    steps are named a block walks no more of them at the bench's batch
    blocks (4 and 8)."""
    for itemsize in (2, 4):
        for L in (50, 32):
            elements = av._bwd_x_plan("stacked", L, 64, itemsize, bb).groups
            _, steps = av.BWD_X_TUNED.get((itemsize, (L + 15) // 16), av.BWD_X_DEFAULT)
            fit = max(e for e in range(1, 5)
                      if av._bwd_x_smem(L, 64, itemsize, "tiles", e, "stacked")
                      <= av.SMEM_OPTIN)
            want = 1 if steps is None else min(math.ceil(bb / steps), fit)
            assert elements == want, (plan, bb)
            if steps is not None and bb <= 8:
                assert math.ceil(bb / elements) <= steps


def test_plan_bytes_and_overrides():
    # bf16 vision: four [64, 72] operand tiles and two [64, 72] kept tiles
    assert av._bwd_x_plan("full", 50, 64, 2).smem_bytes == (4 + 2) * 64 * 72 * 2
    # fewstores keeps no [L, L] tiles
    assert av._bwd_x_plan("fewstores", 50, 64, 4).smem_bytes == 4 * 64 * 68 * 4
    # two warp groups, two units' tiles
    assert av._bwd_x_plan("pair", 32, 64, 2, groups=2).smem_bytes == 2 * (
        4 * 32 * 72 + 2 * 32 * 40) * 2
    # recomputed: two fp32 operand tiles and three row statistics
    assert av._bwd_x_plan("full", 128, 128, 4, 2).smem_bytes == (2 * 128 * 132 + 3 * 128) * 4
    assert av._bwd_x_plan("stacked", 50, 64, 2, 4, groups=3).groups == 3
    with pytest.raises(ValueError, match="shared"):   # three fp32 vision units do not fit
        av._bwd_x_plan("stacked", 50, 64, 4, 4, groups=3)


class _FakeEntry:
    def __init__(self, code=0):
        self.restype = self.argtypes = None
        self.calls, self.code = [], code

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    def __init__(self, code=0):
        self.ccmh_attention_bwd_x = _FakeEntry(code)
        self.ccmh_attention_bwd_headpair = _FakeEntry(code)
        self.ccmh_cuda_error_string = lambda err: b"invalid argument"


def _fake(monkeypatch, code=0):
    lib = _FakeLib(code)
    loads = []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=4242))
    return lib, loads


@pytest.mark.parametrize("kernel", ["backward_x", "backward_headpair"])
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_the_entry_receives_the_plan_in_signature_order(kernel, dtype, code, monkeypatch):
    lib, loads = _fake(monkeypatch)
    B, L, H, Dh, bb = 8, 50, 4, 64, 4
    qkv = torch.zeros((B, L, 3 * H * Dh), dtype=dtype)
    g = torch.zeros((B, L, H * Dh), dtype=dtype)
    dqkv = torch.empty_like(qkv)
    mode = "stacked" if kernel == "backward_x" else "headpair"
    av._launch_bwd_x(qkv, None, g, dqkv, H, bb, mode)
    assert loads == ["attention_bwd_x"]
    entry = getattr(lib, "ccmh_attention_bwd_x" if kernel == "backward_x"
                    else "ccmh_attention_bwd_headpair")
    assert entry.restype is ctypes.c_int
    # device, qkv, mask, g, dqkv, B, L, H, Dh, bb, [mode,] path, groups,
    # smem_bytes, scale, dtype, stream
    n_ints = 9 if kernel == "backward_x" else 8
    assert entry.argtypes == ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints
                              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    plan = av._bwd_x_plan(mode, L, Dh, qkv.element_size(), bb)
    head = (bb, av.MODES.index(mode)) if kernel == "backward_x" else (bb,)
    assert entry.calls == [(None, qkv.data_ptr(), None, g.data_ptr(), dqkv.data_ptr(),
                            B, L, H, Dh, *head, plan.path, plan.groups, plan.smem_bytes,
                            1.0 / math.sqrt(Dh), code, 4242)]


@pytest.mark.parametrize("mode", ["full", "headpair"])
def test_a_refused_plan_raises(mode, monkeypatch):
    """The C entry's refusal (cudaErrorInvalidValue for a plan it does not
    compute the same way) raises in the wrapper."""
    _fake(monkeypatch, code=1)
    qkv = torch.zeros((2, 8, 3 * 32))
    name = "ccmh_attention_bwd_headpair" if mode == "headpair" else "ccmh_attention_bwd_x"
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 1"):
        av._launch_bwd_x(qkv, None, torch.zeros((2, 8, 32)), torch.empty_like(qkv), 2, 2, mode)
