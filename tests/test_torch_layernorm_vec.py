"""The LayerNorm kernels' 16-byte design (``csrc/layernorm.cu``), as far as
the CPU can reach it:

(a) ``_vector_path``, the rule that sends a launch to the kernel's 16-byte
    branch or to its scalar branch;
(b) the kernel's fp32 summation order, emulated in plain PyTorch and held
    against ccmh's ``fused_layer_norm`` / ``fused_add_layer_norm`` (the
    Pallas kernels in interpret mode);
(c) the C entries, resolved once per process, and the order in which the
    wrapper hands them their arguments (through a fake library).

The kernel writes every fp32 operation with a round-to-nearest intrinsic,
so nvcc contracts nothing into an FMA, and each lane sums its values in
the order it holds them: on the 16-byte branch lane l holds chunks l,
l + 32, ... of V = 16 / itemsize values each, on the scalar branch columns
l, l + 32, ...; then five xor shuffles (16, 8, 4, 2, 1) sum the lanes.  The
emulation does the same fp32 operations in the same order, so it differs
from the card only in ``rsqrtf`` (an approximation on the card, rounded
here).  Tolerances: fp32 atol 1e-6 (the port's gate against ccmh on the
CPU, tests/test_torch_layernorm.py), bf16 one ulp at the output scale (the
largest |y|: ccmh's interpreted bf16 chain rounds small outputs up to two
ulps away from the float64 value, where the emulation stays within one),
the sum ``s`` exactly equal (one rounding of an fp32 sum of two bf16
values).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccmh.ops.layernorm import (
    fused_add_layer_norm as jax_fused_add_ln, fused_layer_norm as jax_fused_ln,
)
from ccmh_torch.ops import build
from ccmh_torch.ops import layernorm as ln

LANES = 32


def _view_one_in(shape, dtype):
    """A contiguous tensor whose data starts one element into its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _aligned(shape, dtype):
    t = torch.zeros(shape, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    return t


# (a) ------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
VECTOR_CASES = [
    # (W, activation type, parameter type, which tensor starts one element in, want)
    pytest.param(768, F32, F32, None, True, id="vision-fp32"),
    pytest.param(512, BF16, BF16, None, True, id="text-bf16"),
    pytest.param(1000, BF16, BF16, None, True, id="w1000-bf16"),
    pytest.param(100, F32, F32, None, True, id="w100-fp32-400-bytes"),
    pytest.param(100, BF16, BF16, None, False, id="w100-bf16-200-bytes"),
    pytest.param(1, F32, F32, None, False, id="w1"),
    pytest.param(96, BF16, F32, None, True, id="bf16-x-fp32-params"),
    pytest.param(4, F32, BF16, None, False, id="fp32-x-bf16-params-8-bytes"),
    pytest.param(8, F32, BF16, None, True, id="fp32-x-bf16-params-16-bytes"),
    pytest.param(768, F32, F32, "x", False, id="x-one-in-fp32"),
    pytest.param(512, BF16, BF16, "x", False, id="x-one-in-bf16"),
    pytest.param(512, BF16, BF16, "d", False, id="d-one-in"),
    pytest.param(512, BF16, BF16, "y", False, id="y-one-in"),
    pytest.param(512, BF16, BF16, "s", False, id="s-one-in"),
    pytest.param(512, F32, F32, "scale", False, id="scale-one-in"),
    pytest.param(512, F32, F32, "bias", False, id="bias-one-in"),
]


@pytest.mark.parametrize("W,tdtype,pdtype,offset,want", VECTOR_CASES)
def test_vector_path_rule(W, tdtype, pdtype, offset, want):
    rows = 3
    t = {}
    for name in ("x", "d", "y", "s"):
        t[name] = (_view_one_in if name == offset else _aligned)((rows, W), tdtype)
    for name in ("scale", "bias"):
        t[name] = (_view_one_in if name == offset else _aligned)((W,), pdtype)
    got = ln._vector_path(t["x"], t["d"], t["y"], t["s"], t["scale"], t["bias"])
    assert got is want
    # kernel #4 has no d and s: only the tensors it takes count
    if offset not in ("d", "s"):
        assert ln._vector_path(t["x"], None, t["y"], None, t["scale"], t["bias"]) is want


# (b) ------------------------------------------------------------------------

def _lane_columns(W: int, itemsize: int, vector: bool):
    """[32, K] column indices of each lane's values in the order it holds
    them (-1 where a lane holds fewer than K)."""
    cols = []
    for lane in range(LANES):
        if vector:
            V = 16 // itemsize
            mine = [c * V + j for c in range(lane, W // V, LANES) for j in range(V)]
        else:
            mine = list(range(lane, W, LANES))
        cols.append(mine)
    K = max(len(c) for c in cols)
    return torch.tensor([c + [-1] * (K - len(c)) for c in cols])


def _warp_sum(lanes: torch.Tensor) -> torch.Tensor:
    """[rows, 32] lane values -> [rows] after the xor butterfly, in fp32."""
    idx = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    assert torch.equal(lanes, lanes[:, :1].expand_as(lanes))   # every lane holds the total
    return lanes[:, 0]


def emulated_layer_norm(v: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        out_dtype, vector: bool) -> torch.Tensor:
    """The kernel's fp32 chain on rows ``v`` [rows, W] (fp32, the values
    the kernel holds: x, or x + d rounded to the input type)."""
    rows, W = v.shape
    cols = _lane_columns(W, torch.empty((), dtype=out_dtype).element_size(), vector)
    held = cols >= 0
    vals = torch.where(held, v[:, cols.clamp(min=0)], torch.zeros(()))   # [rows, 32, K]
    Wf = torch.tensor(float(W), dtype=torch.float32)

    acc = torch.zeros((rows, LANES), dtype=torch.float32)
    for k in range(cols.shape[1]):
        acc = acc + vals[:, :, k]                # a value a lane does not hold is 0
    mean = _warp_sum(acc) / Wf
    acc = torch.zeros((rows, LANES), dtype=torch.float32)
    for k in range(cols.shape[1]):
        t = vals[:, :, k] - mean[:, None]
        acc = torch.where(held[:, k], acc + t * t, acc)
    rstd = torch.rsqrt(_warp_sum(acc) / Wf + torch.tensor(ln.EPS, dtype=torch.float32))
    y = ((v - mean[:, None]) * rstd[:, None]) * scale.float() + bias.float()
    return y.to(out_dtype)


def _one_bf16_ulp(scale: float) -> float:
    """The spacing of bf16 values (8 significant bits) at ``scale`` > 0."""
    _, e = np.frexp(scale)
    return float(np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("add", [False, True], ids=["ln", "add_ln"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("W", [96, 100, 512, 768, 1000])
def test_emulated_kernel_order_matches_ccmh(W, dtype, add):
    tdtype, jdtype = (F32, jnp.float32) if dtype == "fp32" else (BF16, jnp.bfloat16)
    rng = np.random.RandomState(W + add)
    rows = 6
    x_np, d_np = (rng.randn(rows, W).astype(np.float32) for _ in range(2))
    sc_np = (1.0 + 0.1 * rng.randn(W)).astype(np.float32)
    bi_np = (0.1 * rng.randn(W)).astype(np.float32)
    x, d = torch.from_numpy(x_np).to(tdtype), torch.from_numpy(d_np).to(tdtype)
    scale, bias = torch.from_numpy(sc_np), torch.from_numpy(bi_np)

    y_out = torch.empty_like(x)
    vector = ln._vector_path(x, d if add else None, y_out, y_out if add else None, scale, bias)
    assert vector == ((W * x.element_size()) % 16 == 0)   # these tensors are aligned
    jx, jd = jnp.asarray(x_np, jdtype), jnp.asarray(d_np, jdtype)
    if add:
        s = (x.float() + d.float()).to(tdtype)      # the kernel's residual add
        got = emulated_layer_norm(s.float(), scale, bias, tdtype, vector)
        want, want_s = jax_fused_add_ln(jx, jd, jnp.asarray(sc_np), jnp.asarray(bi_np))
        np.testing.assert_array_equal(s.float().numpy(), np.asarray(want_s, np.float32))
    else:
        got = emulated_layer_norm(x.float(), scale, bias, tdtype, vector)
        want = jax_fused_ln(jx, jnp.asarray(sc_np), jnp.asarray(bi_np))
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if tdtype == F32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=_one_bf16_ulp(np.abs(want).max()))


# (c) ------------------------------------------------------------------------

class _FakeEntry:
    """A C entry that records its argument types and calls."""

    def __init__(self, code=0):
        self.restype, self._argtypes, self.argtype_sets = None, None, 0
        self.calls, self.code = [], code

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.argtype_sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    def __init__(self, code=0):
        self.ccmh_ln_forward = _FakeEntry(code)
        self.ccmh_add_ln_forward = _FakeEntry(code)
        self.ccmh_cuda_error_string = lambda err: b"invalid argument"


@pytest.mark.parametrize("add", [False, True], ids=["ln", "add_ln"])
def test_c_entry_resolved_once_and_argument_order(add, monkeypatch):
    lib = _FakeLib()
    loads = []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(ln, "_ENTRIES", {})
    rows, W = 5, 512
    x, d, y, s = (_aligned((rows, W), BF16) for _ in range(4))
    scale, bias = _aligned((W,), F32), _aligned((W,), F32)
    odd = _view_one_in((rows, W), BF16)
    for inp in (x, x, odd):
        ln._launch(inp, d if add else None, scale, bias, y, s if add else None, 0, 4242)

    entry = lib.ccmh_add_ln_forward if add else lib.ccmh_ln_forward
    assert loads == ["layernorm"] and entry.argtype_sets == 1
    n_ptrs = 6 if add else 4
    assert entry.restype is ctypes.c_int
    assert entry.argtypes == ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                              + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    ptrs = [x.data_ptr()] + ([d.data_ptr()] if add else []) + [
        scale.data_ptr(), bias.data_ptr(), y.data_ptr()] + ([s.data_ptr()] if add else [])
    # device, pointers, rows, W, dtype (bf16 = 1), param_dtype (fp32 = 0), vector, stream
    assert entry.calls[0] == (0, *ptrs, rows, W, 1, 0, 1, 4242)
    assert entry.calls[1] == entry.calls[0]
    assert entry.calls[2] == (0, odd.data_ptr(), *ptrs[1:], rows, W, 1, 0, 0, 4242)
    other = lib.ccmh_ln_forward if add else lib.ccmh_add_ln_forward
    assert other.calls == [] and other.argtype_sets == 0


def test_refused_launch_raises(monkeypatch):
    """A non-zero code from the C entry (the vector branch refusing data it
    cannot read 16 bytes at a time, a refused launch) raises."""
    monkeypatch.setattr(build, "load", lambda name: _FakeLib(code=1))
    monkeypatch.setattr(ln, "_ENTRIES", {})
    x = _aligned((2, 64), F32)
    with pytest.raises(RuntimeError, match="ccmh_ln_forward: CUDA error 1"):
        ln._launch(x, None, _aligned((64,), F32), _aligned((64,), F32), x.clone(), None, 0, 0)
