"""The fp32 arithmetic of the attention kernels (``csrc/attention.cu``,
``csrc/attention_bwd.cu``), emulated in plain PyTorch and held against
ccmh's ``fused_attention`` and its ``jax.vjp`` (the Pallas kernels in
interpret mode on the CPU).

The kernels run fp32 products on the tensor cores as 3xTF32: each operand
x is split into ``hi = rna(x)`` and ``lo = rna(x - hi)``, TF32 values
rounded to nearest with ties away from zero (PTX ``cvt.rna.tf32.f32``,
which clears the low 13 of fp32's 23 mantissa bits), and each product is
``hi.hi' + hi.lo' + lo.hi'`` accumulated in fp32.  A product of two TF32
values is exact in fp32 (11 + 11 significant bits), so the emulation below
differs from the card only in the order of the fp32 sums.

The card holds the kernels to 1e-4 (forward) and 1e-4 x the output scale
(backward) against their plain versions (``chip_smoke.py``).  Here the
emulated 3xTF32 chain sits at least 10x under those gates at vision
(L=50, H=12, Dh=64) and text (L=32, H=8, causal) widths, while one TF32
pass (``rna(a) . rna(b)``) breaks them: it keeps about three decimal
digits, which is why the kernels do not use it.
"""

import functools
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.clip.model import causal_mask as jax_causal_mask
from ccmh.ops.attention import fused_attention as jax_fused
from ccmh_torch.clip.model import causal_mask
from ccmh_torch.ops import attention_variants as av

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = 1e-4          # chip_smoke.py's ATTN_TOL for fp32
MARGIN = 10.0        # the emulated 3xTF32 error must sit this far under it

SHAPES = {
    # (B, L, H, Dh, causal)
    "vision": (2, 50, 12, 64, False),
    "text": (2, 32, 8, 64, True),
}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: the magnitude rounded to 10
    mantissa bits, half-way cases away from zero, kept as fp32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = sign | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def _heads(qkv, qkv_b, H):
    B, L, D3 = qkv.shape
    x = qkv + qkv_b
    return x.reshape(B, L, 3, H, D3 // 3 // H).permute(2, 0, 3, 1, 4)   # q, k, v [B, H, L, Dh]


def forward_emulated(qkv, qkv_b, mask, H, mm):
    """The forward kernel's fp32 chain with products taken by ``mm``."""
    q, k, v = _heads(qkv, qkv_b, H)
    B, _, L, Dh = q.shape
    logits = mm(q, k.transpose(-1, -2)) * torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    return mm(probs, v).permute(0, 2, 1, 3).reshape(B, L, H * Dh)


def backward_emulated(qkv, qkv_b, mask, g, H, mm):
    """The backward kernel's fp32 chain -> packed dqkv [B, L, 3D]."""
    q, k, v = _heads(qkv, qkv_b, H)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    gh = g.reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    logits = mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    dprobs = mm(gh, v.transpose(-1, -2))
    dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True)) * scale
    dq = mm(dlogits, k)
    dk = mm(dlogits.transpose(-1, -2), q)
    dv = mm(probs.transpose(-1, -2), gh)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, L, 3 * H * Dh)


def _inputs(B, L, H, Dh, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, L, 3 * H * Dh).astype(np.float32)
    b = (0.1 * rng.randn(3 * H * Dh)).astype(np.float32)
    g = rng.randn(B, L, H * Dh).astype(np.float32)
    return qkv, b, g


_CCMH = {}


def _ccmh(shape):
    """ccmh's forward and its VJP at ``shape`` (cached: the interpreted
    Pallas kernels are the slow part)."""
    if shape not in _CCMH:
        B, L, H, Dh, causal = SHAPES[shape]
        qkv, b, g = _inputs(B, L, H, Dh, seed=L + H)
        mask = jax_causal_mask(L) if causal else None
        out, vjp = jax.vjp(lambda x, bb: jax_fused(x, mask, H, qkv_b=bb),
                           jnp.asarray(qkv), jnp.asarray(b))
        dqkv, _ = vjp(jnp.asarray(g))
        _CCMH[shape] = (qkv, b, g, np.asarray(out), np.asarray(dqkv))
    return _CCMH[shape]


def _error(shape, direction, mm):
    """(max abs error of the emulated chain against ccmh, the card's gate)."""
    B, L, H, Dh, causal = SHAPES[shape]
    qkv, b, g, out, dqkv = _ccmh(shape)
    mask = causal_mask(L) if causal else None
    args = (torch.from_numpy(qkv), torch.from_numpy(b), mask)
    if direction == "forward":
        got = forward_emulated(*args, H, mm).numpy()
        return float(np.abs(got - out).max()), GATE
    got = backward_emulated(*args, torch.from_numpy(g), H, mm).numpy()
    return float(np.abs(got - dqkv).max()), GATE * max(1.0, float(np.abs(dqkv).max()))


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                   # under half an ulp rounds down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),  # over half an ulp rounds up
    (3.0, 3.0),
])
def test_tf32_rounding_is_rna(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    # TF32 keeps 10 mantissa bits: the low 13 of fp32's are clear
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_split_is_exact_to_fp32_rounding():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi, lo = split(x)
    # hi + lo carries 22 of fp32's 24 significant bits
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -21)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_sits_under_the_card_gate(shape, direction):
    err, gate = _error(shape, direction, mm_3xtf32)
    assert math.isfinite(err) and err * MARGIN <= gate, (err, gate)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_tf32_pass_breaks_the_card_gate(shape, direction):
    err, gate = _error(shape, direction, mm_1xtf32)
    assert err > gate, (err, gate)


# ---- the ablation kernels #7 (forward_stacked) and #9 (backward_merged)
# of tools/bench_attn_bwd.py (csrc/attention_fwd_stacked.cu,
# csrc/attention_merged.cu), held to the JAX tool's Pallas kernels in
# interpret mode.  #7 takes #1's products.  #9 runs R = bb L merged rows
# under the [R, R] block-diagonal mask, its fp32 products as 3xTF32 with a
# split that rounds toward zero (hi = x with the low 13 mantissa bits
# cleared, lo = x - hi the same way: no conversion instruction); a group of
# G warps shares each 16-row tile (2 up to 128 rows, 4 above), each warp a
# run of its 16-key blocks, and the group combines the warps' row max, sum
# and sum_j e dP, which the emulation follows.

MERGED = {
    # (B, L, H, Dh, causal, bb)
    "vision bb=2": (2, 50, 12, 64, False, 2),
    "text bb=4": (4, 32, 8, 64, True, 4),
    "vision bb=4, 4 warps a tile": (4, 50, 12, 64, False, 4),
}


@functools.lru_cache(maxsize=None)
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_attn_bwd", os.path.join(REPO, "tools", "bench_attn_bwd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tf32_tz(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 rounded toward zero: the low 13 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32_tz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32_tz(a), tf32_tz(b)
    al, bl = tf32_tz(a - ah), tf32_tz(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _pad16(n):
    return (n + 15) // 16 * 16


def _key_shares(R):
    """Each warp's keys of a 16-row tile: the 16-key blocks dealt out in
    order over the group's G warps, the first n_t % G warps one more."""
    n_t = _pad16(R) // 16
    G = 2 if n_t <= 8 else 4
    per, extra = divmod(n_t, G)
    start, out = 0, []
    for p in range(G):
        n = per + (p < extra)
        out.append(slice(16 * start, min(R, 16 * (start + n))))
        start += n
    return out


def merged_backward_emulated(qkv, g, mask, H, bb, mm, shares=False):
    """#9's fp32 chain over R = bb L merged rows -> dqkv [B, L, 3D]; the
    softmax statistics per warp share, combined, when ``shares``."""
    B, L, D3 = qkv.shape
    Dh, R = D3 // 3 // H, bb * L
    q, k, v = qkv.reshape(B // bb, R, 3, H, Dh).permute(2, 0, 3, 1, 4)
    gh = g.reshape(B // bb, R, H, Dh).permute(0, 2, 1, 3)
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    logits = mm(q, k.transpose(-1, -2)) * scale + mask
    dprobs = mm(gh, v.transpose(-1, -2))
    if not shares:
        probs = torch.softmax(logits, dim=-1)
        dot = (dprobs * probs).sum(-1, keepdim=True)
    else:
        stats = []
        for sl in _key_shares(R):
            x, d = logits[..., sl], dprobs[..., sl]
            m = x.amax(-1, keepdim=True)
            e = torch.exp(x - m)
            stats.append((m, e.sum(-1, keepdim=True), (e * d).sum(-1, keepdim=True)))
        m = torch.stack([st[0] for st in stats]).amax(0)
        total = sum(st[1] * torch.exp(st[0] - m) for st in stats)
        u = sum(st[2] * torch.exp(st[0] - m) for st in stats)
        probs = torch.exp(logits - m) * (1.0 / total)
        dot = u / total
    dlogits = probs * (dprobs - dot) * scale
    dq = mm(dlogits, k)
    dk = mm(dlogits.transpose(-1, -2), q)
    dv = mm(probs.transpose(-1, -2), gh)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, L, D3)


_TOOL = {}


def _tool_merged(case):
    """The JAX tool's #9 at ``case`` (cached: interpreted Pallas is slow)."""
    if case not in _TOOL:
        B, L, H, Dh, causal, bb = MERGED[case]
        qkv, _, g = _inputs(B, L, H, Dh, seed=L + bb)
        bias = np.triu(np.full((L, L), -1e9, np.float32), 1) if causal else None
        want = jax_tool().backward_merged(jnp.asarray(qkv), None if bias is None else
                                          jnp.asarray(bias), jnp.asarray(g), H, bb)
        _TOOL[case] = (qkv, g, bias, np.asarray(want))
    return _TOOL[case]


def _merged_error(case, mm):
    B, L, H, Dh, causal, bb = MERGED[case]
    qkv, g, bias, want = _tool_merged(case)
    mask = av.merged_mask(None if bias is None else torch.from_numpy(bias), L, bb)
    got = merged_backward_emulated(torch.from_numpy(qkv), torch.from_numpy(g), mask, H, bb, mm,
                                   shares=True).numpy()
    return float(np.abs(got - want).max()), GATE * max(1.0, float(np.abs(want).max()))


def _stacked_error(mm):
    """#7 at vision (B=2, bb=2, no mask) against the tool's forward_stacked."""
    B, L, H, Dh, _ = SHAPES["vision"]
    if "stacked" not in _TOOL:
        qkv, _, _ = _inputs(B, L, H, Dh, seed=7)
        _TOOL["stacked"] = (qkv, np.asarray(jax_tool().forward_stacked(jnp.asarray(qkv), None,
                                                                      H, 2)))
    qkv, want = _TOOL["stacked"]
    got = forward_emulated(torch.from_numpy(qkv), torch.zeros(3 * H * Dh), None, H, mm).numpy()
    return float(np.abs(got - want).max()), GATE


@pytest.mark.parametrize("case", list(MERGED))
def test_3xtf32_merged_rows_sit_under_the_card_gate(case):
    err, gate = _merged_error(case, mm_3xtf32_tz)
    assert math.isfinite(err) and err * MARGIN <= gate, (err, gate)


@pytest.mark.parametrize("case", list(MERGED))
def test_one_tf32_pass_breaks_the_card_gate_over_merged_rows(case):
    err, gate = _merged_error(case, mm_1xtf32)
    assert err > gate, (err, gate)


def test_3xtf32_stacked_forward_sits_under_the_card_gate():
    err, gate = _stacked_error(mm_3xtf32)
    assert math.isfinite(err) and err * MARGIN <= gate, (err, gate)


def test_one_tf32_pass_breaks_the_card_gate_in_the_stacked_forward():
    err, gate = _stacked_error(mm_1xtf32)
    assert err > gate, (err, gate)


# ---- the ablation kernels #6 (backward_x) and #10 (backward_headpair)
# of tools/bench_attn_bwd.py (csrc/attention_bwd_x.cu), held to the JAX
# tool's Pallas kernels in interpret mode.  Kernel #2's tile design with
# no projection bias, its fp32 products as 3xTF32 with the split toward
# zero; each mode changes one step of the chain (``nosoftmax`` takes
# probs = logits * 0.01, ``novjp`` dlogits = dprobs, ``fewstores`` writes
# dq alone, into the dk slot), #10 is kernel #2's function.

BWD_X = {
    # (B, L, H, Dh, causal, bb): the tool's grid is B // bb
    "vision": (2, 50, 12, 64, False, 2),
    "text": (2, 32, 8, 64, True, 2),
}
BWD_X_CASES = ["full", "nosoftmax", "novjp", "fewstores", "headpair"]


def bwd_x_emulated(qkv, g, mask, H, mode, mm):
    """#6's fp32 chain in ``mode`` (#10: ``"headpair"``, the full chain) ->
    dqkv [B, L, 3D]; ``fewstores`` -> its dq [B, L, D], which the kernel
    writes into the dk slot."""
    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    q, k, v = qkv.reshape(B, L, 3, H, Dh).permute(2, 0, 3, 1, 4)
    gh = g.reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    logits = mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    dprobs = mm(gh, v.transpose(-1, -2))
    probs = logits * 0.01 if mode == "nosoftmax" else torch.softmax(logits, dim=-1)
    if mode == "novjp":
        dlogits = dprobs * scale
    else:
        dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True)) * scale
    dq = mm(dlogits, k)
    if mode == "fewstores":
        return dq.permute(0, 2, 1, 3).reshape(B, L, D3 // 3)
    dk = mm(dlogits.transpose(-1, -2), q)
    dv = mm(probs.transpose(-1, -2), gh)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, L, D3)


def _tool_bwd_x(shape, mode):
    """The JAX tool's #6 in ``mode`` (or #10) at ``shape`` (cached); the
    fewstores case as the dk slot it writes."""
    key = ("bwd_x", shape, mode)
    if key not in _TOOL:
        B, L, H, Dh, causal, bb = BWD_X[shape]
        qkv, _, g = _inputs(B, L, H, Dh, seed=L + H + 6)
        bias = np.triu(np.full((L, L), -1e9, np.float32), 1) if causal else None
        jb = None if bias is None else jnp.asarray(bias)
        tool = jax_tool()
        if mode == "headpair":
            want = tool.backward_headpair(jnp.asarray(qkv), jb, jnp.asarray(g), H, bb)
        else:
            want = tool.backward_x(jnp.asarray(qkv), jb, jnp.asarray(g), H, bb, mode)
        want = np.asarray(want)
        if mode == "fewstores":
            D = H * Dh
            want = want[..., D:2 * D]
        _TOOL[key] = (qkv, g, bias, want)
    return _TOOL[key]


def _bwd_x_error(shape, mode, mm):
    H = BWD_X[shape][2]
    qkv, g, bias, want = _tool_bwd_x(shape, mode)
    mask = None if bias is None else torch.from_numpy(bias)
    got = bwd_x_emulated(torch.from_numpy(qkv), torch.from_numpy(g), mask, H, mode, mm).numpy()
    return float(np.abs(got - want).max()), GATE * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("mode", BWD_X_CASES)
@pytest.mark.parametrize("shape", list(BWD_X))
def test_3xtf32_ablation_backward_sits_under_the_card_gate(shape, mode):
    err, gate = _bwd_x_error(shape, mode, mm_3xtf32_tz)
    assert math.isfinite(err) and err * MARGIN <= gate, (err, gate)


@pytest.mark.parametrize("mode", BWD_X_CASES)
@pytest.mark.parametrize("shape", list(BWD_X))
def test_one_tf32_pass_breaks_the_card_gate_in_the_ablation_backward(shape, mode):
    err, gate = _bwd_x_error(shape, mode, mm_1xtf32)
    assert err > gate, (err, gate)


# ---- the ablation kernel #8 (backward_savedp) of tools/bench_attn_bwd.py
# (csrc/attention_savedp.cu), held to the JAX tool's Pallas kernel in
# interpret mode.  #6 `full`'s tiles with the saved probabilities in place
# of the S product and the softmax: dP = g v^T, dS = p (dP - sum_j dP p)
# scale, dq = dS k, dk = dS^T q, dv = P^T g, its fp32 products as 3xTF32
# with the split toward zero.  The probabilities are the setup input the
# tool builds outside its pallas_call (``savedp_probs``), not the kernel's.


def savedp_emulated(qkv, g, probs, H, mm):
    """#8's fp32 chain from the saved ``probs`` [B, H, L, L] -> dqkv."""
    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    q, k, v = qkv.reshape(B, L, 3, H, Dh).permute(2, 0, 3, 1, 4)
    gh = g.reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    dprobs = mm(gh, v.transpose(-1, -2))
    dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True)) * scale
    dq = mm(dlogits, k)
    dk = mm(dlogits.transpose(-1, -2), q)
    dv = mm(probs.transpose(-1, -2), gh)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(B, L, D3)


def _savedp_error(shape, mm):
    """#8 at ``shape`` (BWD_X's vision and text causal widths) against the
    tool's backward_savedp (cached)."""
    B, L, H, Dh, causal, bb = BWD_X[shape]
    key = ("savedp", shape)
    if key not in _TOOL:
        qkv, _, g = _inputs(B, L, H, Dh, seed=L + H + 8)
        bias = np.triu(np.full((L, L), -1e9, np.float32), 1) if causal else None
        want = jax_tool().backward_savedp(jnp.asarray(qkv), None if bias is None else
                                          jnp.asarray(bias), jnp.asarray(g), H, bb)
        _TOOL[key] = (qkv, g, bias, np.asarray(want))
    qkv, g, bias, want = _TOOL[key]
    tq = torch.from_numpy(qkv)
    probs = av.savedp_probs(tq, None if bias is None else torch.from_numpy(bias), H)
    got = savedp_emulated(tq, torch.from_numpy(g), probs, H, mm).numpy()
    return float(np.abs(got - want).max()), GATE * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("shape", list(BWD_X))
def test_3xtf32_savedp_backward_sits_under_the_card_gate(shape):
    err, gate = _savedp_error(shape, mm_3xtf32_tz)
    assert math.isfinite(err) and err * MARGIN <= gate, (err, gate)


@pytest.mark.parametrize("shape", list(BWD_X))
def test_one_tf32_pass_breaks_the_card_gate_in_the_savedp_backward(shape):
    err, gate = _savedp_error(shape, mm_1xtf32)
    assert err > gate, (err, gate)
