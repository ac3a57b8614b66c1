"""Attention past 128 tokens: the long path of kernels #1 and #2
(``csrc/attention_long.cuh``) against ccmh's ``fused_attention``.

ViT-B/16 (197 tokens), ViT-L/14 (257) and ViT-L/14@336 (577) run the
attention kernels past the short kernels' L <= 128, where their C entries
take the long path.  ccmh's Pallas kernels take any L; here they run in
interpret mode on the CPU, as ccmh's own tests run them.

* The port's wrapper on CPU tensors (its plain versions) against ccmh's
  forward and ``jax.vjp`` at L in {129, 197, 257}, fp32 and bf16, causal
  and key-padded.  Tolerance: fp32 atol 1e-5 of unit-scale outputs
  (rtol 1e-5; the two packages sum the products in other orders), the
  backward 1e-5 of its output scale; bf16 2e-2 (7.8e-3 is one bf16 ulp at
  unit scale, and both round the probabilities and dS to bf16).
* The long kernels' schedules emulated in plain PyTorch, against ccmh: the
  keys in 64-row tiles taken CHUNK columns at a time (the ``mma.sync``
  kernels of ``attention_long.cuh`` 32, the ``wgmma`` kernels 64: one
  accumulator of a warpgroup), each row's max and sum streamed and the
  sum rescaled as the max grows, the probabilities normalised in fp32
  before they are rounded to T, the backward's D_i streamed with the same
  rescale over the unrounded probabilities, dq summed query-major and dk,
  dv key-major; fp32 products as 3xTF32 split toward zero.  The card holds
  the kernels to fp32 1e-4 and bf16 2e-2 (``chip_smoke.py``); the
  emulation sits 10x under the fp32 gate and within the bf16 gate.
* The fp32 ``wgmma`` kernels' products emulated as they take them: 3xTF32
  in k-steps of 8 columns (lo.hi + hi.lo + hi.hi, split toward zero), a
  sum over the sequence in the order in which an accumulator's columns
  enter as the register A operand; against ``ccmh`` under the fp32 gate,
  also at the fp32 backward's block edges (L = 193, 320, 321), where its
  32-row stages take the same k-steps in the same order.
* The fp32 backward's shared-memory plan and grid
  (``csrc/attention_bwd32_plan.cuh``), compiled here with the host
  compiler: each warp-specialised kernel's bytes fit a block, and the
  blocks' consumers hold every row of L once.
* The ``wgmma`` kernels' softmax on rows that a large finite mask covers
  entirely (-1e9, -1e30, finfo.min / 2): before the repair the exponent
  was 2^(x log2 e - lse2) in one multiply-add, lse2 = round(m log2 e) +
  log2 sum, whose rounding at |m| reaches the exponent (the emulation
  reproduces the fault); after it, 2^((x - m) log2 e - log2 sum) on any
  tile with a mask gives ``ccmh``'s uniform row.
* The one-pass bf16 forward (the logits of a 64-query tile held in
  registers, up to ``ONEPASS_MAX_L`` keys) emulated in plain PyTorch
  against ccmh at L = 197, 257 and the limit +- 1, with the causal,
  key-padded and finite-mask-row forms: the whole row's max and sum, e =
  2^((x - m) log2 e) (one multiply-add on full unmasked tiles), p = e *
  (1 / sum) in fp32 rounded to bf16, p v in 64-column steps (the entry
  gives limit + 1 to the resident kernel, whose arithmetic is the two-pass
  schedule's above).  Tolerance: the bf16 gate (2e-2) over BF16_MARGIN
  (10), 2e-3: the emulation sits at 9.8e-4 or under (both round the same
  p; their sums run in other orders).
* The one-pass bf16 backward (its query side holds each row's fp32
  probabilities in registers, up to ``BWD_ONEPASS_MAX_L`` keys) emulated
  in plain PyTorch against ccmh's ``jax.vjp`` at L = 197, 257 and the limit
  and limit + 1, with no mask, the finite-mask rows, causal and key-padded:
  the query side (p = e * (1 / sum) in the one-pass exponent forms, D over
  the fp32 p and dP in key-tile order, the second dP sweep, dq summed tile
  by tile) and then the dk dv kernel with p formed from the row statistics
  it reads (lse2, or m and log2 sum under a mask).  Tolerance: the bf16
  gate over BF16_MARGIN, 2e-3 of the output scale (the emulation sits at
  1.8e-3 or under: single bf16 flips where the two sum in other orders).
* The C entries' rule for the kernel family past 128 tokens
  (``csrc/attention_family.cuh``), compiled here with the host compiler:
  which (L, head dim, type, alignment) take the ``wgmma`` kernels and
  which the ``mma.sync`` ones of ``attention_long.cuh``; which L #1's
  bf16 forward takes to the one-pass kernel and which to the resident
  two-pass one; which L #2's bf16 backward takes to the one-pass query
  side; the wrapper's count by the family an entry reports, and the
  backward entry's row-statistics buffer.
* The two faults found on the card: the kernels' checks refused L > 128
  and codes of more than 256 bits.
"""

import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.clip.model import causal_mask as jax_causal_mask
from ccmh.ops.attention import fused_attention as jax_fused
from ccmh_torch.clip.model import causal_mask
from ccmh_torch.ops import attention as attn
from ccmh_torch.ops import hamming as ham

TILE = 64                 # the long kernels' key tile
# the logit columns a warp (mma.sync) or a warpgroup (wgmma) holds at a time
SCHEDULES = [pytest.param(32, id="mma_sync"), pytest.param(64, id="wgmma")]
GATE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # the card's gates
MARGIN = 10.0             # the emulated fp32 chain sits this far under its gate

CASES = [
    # (B, L, H, Dh, mask)
    pytest.param(2, 129, 2, 64, "causal", id="L129-causal"),
    pytest.param(2, 197, 2, 32, "none", id="L197-vitb16"),
    pytest.param(1, 257, 2, 64, "pad", id="L257-keypad"),
]


# rows 0, 1 and L - 1 that a finite mask covers entirely, at these values
MASKED_ROWS = (-1e9, -1e30, float(np.finfo(np.float32).min) / 2)


def _mask(L, kind, jax_side=False):
    if kind == "causal":
        return jax_causal_mask(L) if jax_side else causal_mask(L)
    if kind in ("pad", "rows"):
        m = np.zeros((L, L), np.float32)
        if kind == "pad":
            m[:, L - L // 3:] = -np.inf          # the last third of the keys padded
        else:
            for row, value in zip((0, 1, L - 1), MASKED_ROWS):
                m[row] = value
        return jnp.asarray(m) if jax_side else torch.from_numpy(m)
    return None


def _inputs(B, L, H, Dh, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, L, 3 * H * Dh).astype(np.float32)
    b = (0.1 * rng.randn(3 * H * Dh)).astype(np.float32)
    g = rng.randn(B, L, H * Dh).astype(np.float32)
    return qkv, b, g


_CCMH = {}


def _ccmh(B, L, H, Dh, kind, dtype):
    """ccmh's forward and VJP (cached: the interpreted kernels are slow)."""
    key = (B, L, H, Dh, kind, dtype)
    if key not in _CCMH:
        qkv, b, g = _inputs(B, L, H, Dh, seed=L + H)
        jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        mask = _mask(L, kind, jax_side=True)
        out, vjp = jax.vjp(lambda x, bb: jax_fused(x, mask, H, qkv_b=bb),
                           jnp.asarray(qkv).astype(jd), jnp.asarray(b).astype(jd))
        dqkv, _ = vjp(jnp.asarray(g).astype(jd))
        _CCMH[key] = (np.asarray(out.astype(jnp.float32)),
                      np.asarray(dqkv.astype(jnp.float32)))
    return _CCMH[key]


def _port_inputs(B, L, H, Dh, dtype):
    qkv, b, g = _inputs(B, L, H, Dh, seed=L + H)
    return (torch.from_numpy(qkv).to(dtype), torch.from_numpy(b).to(dtype),
            torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,L,H,Dh,kind", CASES)
def test_port_matches_ccmh_past_128_tokens(B, L, H, Dh, kind, dtype):
    qkv, b, g = _port_inputs(B, L, H, Dh, dtype)
    out, dqkv = _ccmh(B, L, H, Dh, kind, dtype)
    x = qkv.clone().requires_grad_()
    got = attn.fused_attention(x, _mask(L, kind), H, qkv_b=b)
    got.backward(g)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.detach().float().numpy(), out, atol=tol, rtol=tol)
    scale = max(1.0, float(np.abs(dqkv).max()))
    np.testing.assert_allclose(x.grad.float().numpy(), dqkv, atol=tol * scale, rtol=0)


# ---- the long kernels' schedule, emulated

def _split_tz(x):
    """x = hi + lo, each with the low 13 mantissa bits cleared (FragTz)."""
    cut = lambda t: (t.contiguous().view(torch.int32) & -8192).view(torch.float32)  # noqa: E731
    hi = cut(x)
    return hi, cut(x - hi)


# the k order of an 8-column step of a tf32 product whose A operand is an
# accumulator in registers: A's k = t and t + 4 hold its columns 2 t and
# 2 t + 1 (acc_to_a32), which split_tile_t's transposed B tile follows
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _mm(a, b, dtype, steps=False, acc_a=False):
    """A product as the kernels take it: bf16 values multiplied exactly and
    summed in fp32; fp32 as 3xTF32 split toward zero.  ``steps``: as the
    fp32 wgmma kernels take it, k-steps of 8 columns, each lo.hi + hi.lo +
    hi.hi added to the fp32 sum in that order; ``acc_a``: A is an
    accumulator in registers, its 8 columns in K_ORDER."""
    if dtype == torch.bfloat16:
        return a @ b
    (ah, al), (bh, bl) = _split_tz(a), _split_tz(b)
    if not steps:
        return al @ bh + ah @ bl + ah @ bh
    K, out = a.shape[-1], 0.0
    for k0 in range(0, K, 8):
        idx = torch.tensor([k0 + i for i in (K_ORDER if acc_a else range(8)) if k0 + i < K])
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            out = out + x[..., idx] @ y[..., idx, :]
    return out


def _heads(qkv, b, H, dtype):
    B, L, D3 = qkv.shape
    x = (qkv + b).to(dtype).float()       # the bias folded in T
    return x.reshape(B, L, 3, H, D3 // 3 // H).permute(2, 0, 3, 1, 4)   # [B, H, L, Dh]


def _logits(q, k, cols, mask, dtype, scale, steps=False):
    s = _mm(q, k[..., cols, :].transpose(-1, -2), dtype, steps) * scale
    return s + mask[:, cols] if mask is not None else s


def _chunks(L, chunk):
    for k0 in range(0, L, TILE):
        for n0 in range(k0, min(k0 + TILE, L), chunk):
            yield slice(n0, min(n0 + chunk, L))


def _stats(q, k, v, gh, mask, dtype, scale, chunk, steps=False):
    """Pass 1: each row's max, sum and (with gh) D numerator, streamed."""
    mx = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    dn = torch.zeros(q.shape[:-1])
    for cols in _chunks(q.shape[-2], chunk):
        s = _logits(q, k, cols, mask, dtype, scale, steps)
        nm = torch.maximum(mx, s.amax(-1))
        corr = torch.where(mx == -math.inf, torch.zeros(()), torch.exp(mx - nm))
        p = torch.exp(s - nm[..., None])
        l = l * corr + p.sum(-1)
        if gh is not None:
            dp = _mm(gh, v[..., cols, :].transpose(-1, -2), dtype, steps)
            dn = dn * corr + (p * dp).sum(-1)
        mx = nm
    return mx, l, dn


def forward_long(qkv, b, mask, H, dtype, chunk, steps=False):
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    mx, l, _ = _stats(q, k, v, None, mask, dtype, scale, chunk, steps)
    ctx = torch.zeros_like(q)
    for cols in _chunks(L, chunk):
        s = _logits(q, k, cols, mask, dtype, scale, steps)
        p = torch.exp(s - mx[..., None]) * (1.0 / l)[..., None]
        ctx = ctx + _mm(p.to(dtype).float(), v[..., cols, :], dtype, steps, acc_a=True)
    return ctx.permute(0, 2, 1, 3).reshape(B, L, H * Dh).to(dtype)


def backward_long(qkv, b, mask, g, H, dtype, chunk, steps=False):
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    gh = g.to(dtype).float().reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    mx, l, dn = _stats(q, k, v, gh, mask, dtype, scale, chunk, steps)
    inv = 1.0 / l
    d = dn * inv

    def p_ds(rows, cols):
        """p and dS scale of queries ``rows`` against keys ``cols``."""
        s = _mm(q[..., rows, :], k[..., cols, :].transpose(-1, -2), dtype, steps) * scale
        if mask is not None:
            s = s + mask[rows, cols]
        p = torch.exp(s - mx[..., rows, None]) * inv[..., rows, None]
        dp = _mm(gh[..., rows, :], v[..., cols, :].transpose(-1, -2), dtype, steps)
        return p, p * (dp - d[..., rows, None]) * scale

    def acc(a, y):
        return _mm(a.to(dtype).float(), y, dtype, steps, acc_a=True)

    everyone = slice(0, L)
    dq = torch.zeros_like(q)          # phase 1, query-major: dq over the key chunks
    for cols in _chunks(L, chunk):
        _, ds = p_ds(everyone, cols)
        dq = dq + acc(ds, k[..., cols, :])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)   # phase 2, key-major
    for rows in _chunks(L, chunk):
        p, ds = p_ds(rows, everyone)
        dv = dv + acc(p.transpose(-1, -2), gh[..., rows, :])
        dk = dk + acc(ds.transpose(-1, -2), q[..., rows, :])
    out = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4)
    return out.reshape(B, L, 3 * H * Dh).to(dtype)


@pytest.mark.parametrize("chunk", SCHEDULES)
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,L,H,Dh,kind", CASES)
def test_long_schedule_matches_ccmh(B, L, H, Dh, kind, dtype, direction, chunk):
    qkv, b, g = _port_inputs(B, L, H, Dh, dtype)
    out, dqkv = _ccmh(B, L, H, Dh, kind, dtype)
    mask = _mask(L, kind)
    if direction == "forward":
        got, want, scale = forward_long(qkv, b, mask, H, dtype, chunk), out, 1.0
    else:
        got, want = backward_long(qkv, b, mask, g, H, dtype, chunk), dqkv
        scale = max(1.0, float(np.abs(dqkv).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    gate = GATE[dtype] * scale / (MARGIN if dtype == torch.float32 else 1.0)
    assert math.isfinite(err) and err <= gate, (err, gate)


# the fp32 backward's block edges (csrc/attention_bwd32_plan.cuh): a block
# holds 128 resident rows, two consumers of 64, and streams 32-row stages;
# L = 193 leaves its last block one consumer of one row, 320 two consumers
# (64 + 0 rows: the second idle), 321 one row past that
BWD32_EDGES = [pytest.param(1, L, 1, 64, kind, id=f"L{L}-{kind}")
               for L in (193, 320, 321) for kind in ("none", "causal")]


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("B,L,H,Dh,kind", CASES + BWD32_EDGES)
def test_tf32_wgmma_schedule_matches_ccmh(B, L, H, Dh, kind, direction):
    """The fp32 wgmma kernels' products: k-steps of 8, three TF32 products
    each, the sums over the sequence in the accumulator's column order."""
    dtype = torch.float32
    qkv, b, g = _port_inputs(B, L, H, Dh, dtype)
    out, dqkv = _ccmh(B, L, H, Dh, kind, dtype)
    mask = _mask(L, kind)
    if direction == "forward":
        got, want, scale = forward_long(qkv, b, mask, H, dtype, TILE, steps=True), out, 1.0
    else:
        got, want = backward_long(qkv, b, mask, g, H, dtype, TILE, steps=True), dqkv
        scale = max(1.0, float(np.abs(dqkv).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    gate = GATE[dtype] * scale / MARGIN
    assert math.isfinite(err) and err <= gate, (err, gate)


# ---- the wgmma kernels' softmax where a finite mask covers a row entirely

LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)   # the kernels' kLog2e


def _fma(x, c, b):
    """fmaf(x, c, b) in fp32: the product exact, one rounding."""
    return (x.double() * c.double() + b.double()).float()


def _exp(x, m, l2, lse2, form):
    """exp(x - m) / sum of a tile with a mask, as the kernels form it
    (ex2.approx taken as exp2): ``before`` the repair 2^(x log2 e - lse2)
    in one multiply-add; ``after`` it 2^((x - m) log2 e - log2 sum)."""
    if form == "before":
        return torch.exp2(_fma(x, LOG2E, -lse2))
    return torch.exp2(_fma(x - m, LOG2E, -l2))


def _stats64(x, dp, form):
    """Stats64 over 64-key tiles, every tile masked: each row's max, sum of
    exponentials and D numerator, the sums rescaled as the max grows; the
    exponent from x and the rounded m log2 e before the repair, from x - m
    after it."""
    mx = torch.full(x.shape[:-1], -math.inf)
    l, dn = torch.zeros(x.shape[:-1]), torch.zeros(x.shape[:-1])
    for k0 in range(0, x.shape[-1], TILE):
        xs, dps = x[..., k0:k0 + TILE], dp[..., k0:k0 + TILE]
        nm = torch.maximum(mx, xs.amax(-1))
        corr = torch.where(mx == -math.inf, torch.zeros(()), torch.exp2((mx - nm) * LOG2E))
        l, dn, mx = l * corr, dn * corr, nm
        m = torch.where(mx == -math.inf, torch.zeros(()), mx)[..., None]
        if form == "before":
            p = torch.exp2(_fma(xs, LOG2E, -(m * LOG2E)))
        else:
            p = torch.exp2((xs - m) * LOG2E)
        l, dn = l + p.sum(-1), dn + (p * dps).sum(-1)
    return mx, l, dn


def wgmma_softmax(qkv, b, mask, g, H, dtype, form):
    """The wgmma kernels' forward and backward under a mask, with their
    exponent ``form`` -> (ctx, packed dqkv)."""
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    gh = g.to(dtype).float().reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    x = _mm(q, k.transpose(-1, -2), dtype) * scale + mask
    dp = _mm(gh, v.transpose(-1, -2), dtype)
    mx, l, dn = _stats64(x, dp, form)
    m = torch.where(mx == -math.inf, torch.zeros(()), mx)
    l2 = torch.log2(l)
    lse2 = m * LOG2E + l2
    p = _exp(x, m[..., None], l2[..., None], lse2[..., None], form)
    ds = p * (dp - (dn * (1.0 / l))[..., None]) * scale
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    ctx = _mm(rnd(p), v, dtype)
    grads = [_mm(rnd(ds), k, dtype), _mm(rnd(ds).transpose(-1, -2), q, dtype),
             _mm(rnd(p).transpose(-1, -2), gh, dtype)]
    out = ctx.permute(0, 2, 1, 3).reshape(B, L, H * Dh).to(dtype)
    dqkv = torch.stack(grads, dim=2).permute(0, 3, 2, 1, 4).reshape(B, L, 3 * H * Dh).to(dtype)
    return out, dqkv


@pytest.mark.parametrize("form", ["before", "after"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_softmax_on_rows_a_finite_mask_covers(dtype, form):
    """Rows 0, 1 and L - 1 masked entirely at -1e9, -1e30 and finfo.min / 2
    (ccmh gives each a uniform row): before the repair each row breaks the
    gate, after it every output is within the gate."""
    B, L, H, Dh = 1, 257, 2, 64
    qkv, b, g = _port_inputs(B, L, H, Dh, dtype)
    out, dqkv = _ccmh(B, L, H, Dh, "rows", dtype)
    got, dgot = wgmma_softmax(qkv, b, _mask(L, "rows"), g, H, dtype, form)
    err = np.abs(got.float().numpy() - out)[0]            # [L, D]
    scale = max(1.0, float(np.abs(dqkv).max()))
    gate = GATE[dtype] / (MARGIN if dtype == torch.float32 else 1.0)
    if form == "before":
        for row, value in zip((0, 1, L - 1), MASKED_ROWS):
            worst = float(err[row].max())
            assert not (math.isfinite(worst) and worst <= gate), (value, worst)
        return
    err_b = float(np.abs(dgot.float().numpy() - dqkv).max())
    assert math.isfinite(float(err.max())) and float(err.max()) <= gate, (err.max(), gate)
    assert math.isfinite(err_b) and err_b <= gate * scale, (err_b, gate * scale)


# ---- the one-pass bf16 forward: the whole logit row in registers

BF16_MARGIN = 10.0        # the one-pass emulation sits this far under the bf16 gate
LIMIT = attn.ONEPASS_MAX_L    # the one-pass kernel's keys (kOnePassMaxL)
ONEPASS_CASES = [
    pytest.param(197, "none", id="L197-vitb16"),
    pytest.param(257, "rows", id="L257-maskedrows"),
    pytest.param(LIMIT - 1, "causal", id="limit-1-causal"),
    pytest.param(LIMIT + 1, "pad", id="limit+1-keypad"),
]
_CCMH_FWD = {}


def _ccmh_forward(B, L, H, Dh, kind):
    """ccmh's bf16 forward (cached: the interpreted kernel is slow)."""
    key = (B, L, H, Dh, kind)
    if key not in _CCMH_FWD:
        qkv, b, _ = _inputs(B, L, H, Dh, seed=L + H)
        out = jax_fused(jnp.asarray(qkv).astype(jnp.bfloat16), _mask(L, kind, jax_side=True), H,
                        qkv_b=jnp.asarray(b).astype(jnp.bfloat16))
        _CCMH_FWD[key] = np.asarray(out.astype(jnp.float32))
    return _CCMH_FWD[key]


def onepass_tiles(L):
    """The one-pass kernel's column tiles (start, end): 64 keys each, and
    16 for a last tile of <= 16 keys (attention.cu launch_onepass)."""
    rem = L % TILE
    nt = L // TILE + (rem > 16)
    return [(TILE * j, TILE * (j + 1)) for j in range(nt)] + (
        [(TILE * nt, TILE * nt + 16)] if 0 < rem <= 16 else [])


def _onepass_logits(q, k, mask, scale):
    """The raw products s = q k^T (bf16 values, fp32 sums) and the logits
    x = s * scale + mask."""
    s = _mm(q, k.transpose(-1, -2), torch.bfloat16)
    x = s * scale
    return s, (x + mask if mask is not None else x)


def _onepass_exp(s, x, mask, scale):
    """e = exp(x - m) over the whole row in the one-pass kernels' exponent
    forms (tile_exp; see forward_onepass) -> (e, finite_max(m))."""
    L = x.shape[-1]
    m = x.amax(-1, keepdim=True)
    mf = torch.where(m == -math.inf, torch.zeros(()), m)   # finite_max
    mb = mf * LOG2E                                          # max_log2e
    e = torch.empty_like(x)
    for j0, j1 in onepass_tiles(L):
        cols = slice(j0, min(j1, L))
        if mask is not None:
            e[..., cols] = torch.exp2((x[..., cols] - mf) * LOG2E)
        elif j1 <= L:
            e[..., cols] = torch.exp2(_fma(s[..., cols], scale * LOG2E, -mb))
        else:
            e[..., cols] = torch.exp2(_fma(x[..., cols], LOG2E, -mb))
    return e, mf


def forward_onepass(qkv, b, mask, H):
    """The one-pass kernel's bf16 forward: the logits of every key at once;
    each row's max over the whole row; e in the kernel's exponent forms (a
    call with a mask 2^((x - m) log2 e); without one a full tile takes the
    raw product in one multiply-add, 2^(s (scale log2 e) - m log2 e), and the
    last partial tile 2^(x log2 e - m log2 e)); the row's sum of e; p = e *
    (1 / sum) in fp32, rounded to bf16; ctx = p v summed in fp32 over the
    key tiles in order."""
    dtype = torch.bfloat16
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    s, x = _onepass_logits(q, k, mask, scale)
    e, _ = _onepass_exp(s, x, mask, scale)
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dtype).float()
    ctx = torch.zeros_like(q)
    for j0, j1 in onepass_tiles(L):
        cols = slice(j0, min(j1, L))
        ctx = ctx + p[..., cols] @ v[..., cols, :]
    return ctx.permute(0, 2, 1, 3).reshape(B, L, H * Dh).to(dtype)


@pytest.mark.parametrize("L,kind", ONEPASS_CASES)
def test_onepass_schedule_matches_ccmh(L, kind):
    B, H, Dh = 1, 2, 64
    qkv, b, _ = _port_inputs(B, L, H, Dh, torch.bfloat16)
    want = _ccmh_forward(B, L, H, Dh, kind)
    got = forward_onepass(qkv, b, _mask(L, kind), H).float().numpy()
    err = float(np.abs(got - want).max())
    gate = GATE[torch.bfloat16] / BF16_MARGIN
    assert math.isfinite(err) and err <= gate, (err, gate)
    if kind == "rows":     # ccmh's uniform rows: the mean of v over every key
        _, _, v = _heads(qkv, b, H, torch.bfloat16)
        mean = v.mean(-2).reshape(B, H * Dh)        # [B, D]: v is [B, H, L, Dh]
        for row in (0, 1, L - 1):
            np.testing.assert_allclose(got[:, row], mean.numpy(), atol=GATE[torch.bfloat16])


# ---- the one-pass bf16 backward: the query side with each row's p in registers

BWD_LIMIT = attn.BWD_ONEPASS_MAX_L    # the one-pass query side's keys (kBwdOnePassMaxL)
BWD_ONEPASS_CASES = [
    pytest.param(197, "none", id="L197-vitb16"),
    pytest.param(257, "rows", id="L257-maskedrows"),
    pytest.param(BWD_LIMIT, "causal", id="limit-causal"),
    pytest.param(BWD_LIMIT + 1, "pad", id="limit+1-keypad"),
]


def backward_onepass(qkv, b, mask, g, H):
    """The bf16 backward as the one-pass query side and kernel 2 take it.
    Query side (attention_bwd_onepass_q): every logit of the row at once; p
    = e * (1 / sum) in fp32 with e in the one-pass exponent forms; D = sum_j
    p dP over the fp32 p and dP = g v^T, the key tiles in order; a second
    sweep: dS = p (dP - D) scale rounded to bf16, dq += dS k tile by tile;
    each row's (m log2 e + log2 sum, D, m, log2 sum) to the statistics
    buffer.  Kernel 2 (dk dv, key-major): p from those statistics in its
    forms (a call with a mask 2^((x - m) log2 e - log2 sum); without one a
    full key tile 2^(s (scale log2 e) - lse2), the last partial one 2^(x
    log2 e - lse2)), dS = p (dP - D) scale; dv += p^T g and dk += dS^T q
    over 64-query tiles, both rounded to bf16 first."""
    dtype = torch.bfloat16
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    gh = g.to(dtype).float().reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    s, x = _onepass_logits(q, k, mask, scale)
    e, mf = _onepass_exp(s, x, mask, scale)
    total = e.sum(-1, keepdim=True)
    p = e * (1.0 / total)
    dp = _mm(gh, v.transpose(-1, -2), dtype)
    tiles = [slice(j0, min(j1, L)) for j0, j1 in onepass_tiles(L)]
    d = torch.zeros_like(total)
    for cols in tiles:
        d = d + (p[..., cols] * dp[..., cols]).sum(-1, keepdim=True)
    dq = torch.zeros_like(q)
    for cols in tiles:
        ds = (p[..., cols] * (dp[..., cols] - d) * scale).to(dtype).float()
        dq = dq + ds @ k[..., cols, :]
    l2 = torch.log2(total)                 # the statistics kernel 2 reads
    lse2 = mf * LOG2E + l2
    p2 = torch.empty_like(x)
    for k0 in range(0, L, TILE):
        cols = slice(k0, min(k0 + TILE, L))
        if mask is not None:
            p2[..., cols] = torch.exp2(_fma(x[..., cols] - mf, LOG2E, -l2))
        elif k0 + TILE <= L:
            p2[..., cols] = torch.exp2(_fma(s[..., cols], scale * LOG2E, -lse2))
        else:
            p2[..., cols] = torch.exp2(_fma(x[..., cols], LOG2E, -lse2))
    ds2 = p2 * (dp - d) * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for rows in _chunks(L, TILE):
        dv = dv + p2[..., rows, :].transpose(-1, -2).to(dtype).float() @ gh[..., rows, :]
        dk = dk + ds2[..., rows, :].transpose(-1, -2).to(dtype).float() @ q[..., rows, :]
    out = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4)
    return out.reshape(B, L, 3 * H * Dh).to(dtype)


@pytest.mark.parametrize("L,kind", BWD_ONEPASS_CASES)
def test_onepass_backward_schedule_matches_ccmh(L, kind):
    """The one-pass backward's schedule against ccmh's jax.vjp (cached by
    _ccmh) under the bf16 gate over BF16_MARGIN, times the output scale (the
    entry gives limit + 1 to the three kernels, whose schedule
    test_long_schedule_matches_ccmh holds)."""
    B, H, Dh = 1, 2, 64
    qkv, b, g = _port_inputs(B, L, H, Dh, torch.bfloat16)
    _, want = _ccmh(B, L, H, Dh, kind, torch.bfloat16)
    got = backward_onepass(qkv, b, _mask(L, kind), g, H).float().numpy()
    err = float(np.abs(got - want).max())
    gate = GATE[torch.bfloat16] / BF16_MARGIN * max(1.0, float(np.abs(want).max()))
    assert math.isfinite(err) and err <= gate, (err, gate)


# ---- the kernel family past 128 tokens: the C entries' rule, and the count

_CSRC = os.path.join(os.path.dirname(attn.__file__), os.pardir, "csrc")
ALIGNED, ODD = 1 << 20, (1 << 20) + 8      # addresses only: the rule reads no memory
# (L, head dim, dtype code, which pointer is 8 bytes off 16-byte alignment, family)
FAMILY_CASES = [
    (257, 64, 1, None, "long_wgmma"),       # ViT-L/14, bf16
    (197, 64, 1, None, "long_wgmma"),       # ViT-B/16
    (577, 64, 1, None, "long_wgmma"),       # ViT-L/14@336
    (129, 64, 1, None, "long_wgmma"),
    (4096, 64, 1, None, "long_wgmma"),
    (128, 64, 1, None, "short"),
    (50, 64, 0, None, "short"),
    (257, 64, 0, None, "long_wgmma"),       # fp32: 3xTF32 on wgmma
    (197, 64, 0, None, "long_wgmma"),
    (577, 64, 0, None, "long_wgmma"),
    (128, 64, 0, None, "short"),
    (200, 128, 1, None, "long_mma"),
    (200, 128, 0, None, "long_mma"),
    (150, 30, 1, None, "long_mma"),
    (257, 64, 1, 0, "long_mma"),            # qkv a view at an odd offset
    (257, 64, 1, 1, "long_mma"),            # the projection bias
    (257, 64, 1, 2, "long_mma"),            # out (#1) or g (#2)
    (257, 64, 0, 0, "long_mma"),
    (257, 64, 0, 1, "long_mma"),
    (257, 64, 0, 2, "long_mma"),
]


def _rule_library(tmp_path_factory):
    """csrc/attention_family.cuh built with the host compiler into a small
    library: ``family`` (attention_family, both entries' rule),
    ``fwd_family`` (attention_fwd_family, #1's forward) and ``bwd_family``
    (attention_bwd_family, #2's backward)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("family")
    src = d / "family.cc"
    src.write_text('#include "attention_family.cuh"\n'
                   'extern "C" int family(int L, int Dh, int dt, const void* a, const void* b,'
                   ' const void* c, const void* e) {\n'
                   '  return ccmh::attention_family(L, Dh, dt, a, b, c, e);\n}\n'
                   'extern "C" int fwd_family(int L, int Dh, int dt, const void* a,'
                   ' const void* b, const void* c) {\n'
                   '  return ccmh::attention_fwd_family(L, Dh, dt, a, b, c);\n}\n'
                   'extern "C" int bwd_family(int L, int Dh, int dt, const void* a,'
                   ' const void* b, const void* c, const void* e) {\n'
                   '  return ccmh::attention_bwd_family(L, Dh, dt, a, b, c, e);\n}\n')
    lib = d / "family.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-I",
                    os.path.abspath(_CSRC), "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def rule_library(tmp_path_factory):
    return _rule_library(tmp_path_factory)


@pytest.fixture(scope="module")
def family_rule(rule_library):
    """The C entries' family rule (csrc/attention_family.cuh), built with
    the host compiler into a small library."""
    fn = rule_library.family
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    return fn


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("L,Dh,dtype,odd,want", FAMILY_CASES)
def test_entries_take_the_wgmma_kernels_for_every_tower(family_rule, L, Dh, dtype, odd, want,
                                                        kernel):
    # #1 passes qkv, qkv_b, out; #2 qkv, qkv_b, g, dqkv
    ptrs = [ALIGNED] * (3 if kernel == "fwd" else 4) + [None] * (1 if kernel == "fwd" else 0)
    if odd is not None:
        ptrs[odd] = ODD
    assert attn.FAMILIES[family_rule(L, Dh, dtype, *ptrs)] == want
    if odd != 1:      # no projection bias at all takes the same family
        ptrs[1] = None
        assert attn.FAMILIES[family_rule(L, Dh, dtype, *ptrs)] == want


RESIDENT = attn.RESIDENT_MAX_L
# #1's forward: (L, head dim, dtype code, the pointer off 16-byte alignment,
# family): bf16 at head dim 64 up to LIMIT keys in one pass, past it up to
# RESIDENT in two over the head's keys in shared memory, past that and in
# fp32 on the two-pass wgmma kernels that stream the keys
FWD_FAMILY_CASES = [
    (197, 64, 1, None, "long_onepass"),     # ViT-B/16, bf16
    (257, 64, 1, None, "long_onepass"),     # ViT-L/14
    (256, 64, 1, None, "long_onepass"),
    (129, 64, 1, None, "long_onepass"),
    (LIMIT - 1, 64, 1, None, "long_onepass"),
    (LIMIT, 64, 1, None, "long_onepass"),
    (LIMIT + 1, 64, 1, None, "long_resident"),
    (577, 64, 1, None, "long_resident"),    # ViT-L/14@336
    (RESIDENT, 64, 1, None, "long_resident"),
    (RESIDENT + 1, 64, 1, None, "long_wgmma"),
    (4096, 64, 1, None, "long_wgmma"),
    (128, 64, 1, None, "short"),
    (257, 64, 0, None, "long_wgmma"),       # fp32: 3xTF32, two passes
    (197, 64, 0, None, "long_wgmma"),
    (LIMIT, 64, 0, None, "long_wgmma"),
    (577, 64, 0, None, "long_wgmma"),
    (200, 128, 1, None, "long_mma"),
    (257, 64, 1, 0, "long_mma"),            # qkv a view at an odd offset
    (257, 64, 1, 1, "long_mma"),            # the projection bias
    (257, 64, 1, 2, "long_mma"),            # out
]


@pytest.mark.parametrize("L,Dh,dtype,odd,want", FWD_FAMILY_CASES)
def test_forward_takes_the_one_pass_kernel_up_to_its_limit(rule_library, L, Dh, dtype, odd,
                                                           want):
    fn = rule_library.fwd_family
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    ptrs = [ALIGNED] * 3
    if odd is not None:
        ptrs[odd] = ODD
    assert attn.FAMILIES[fn(L, Dh, dtype, *ptrs)] == want
    if odd != 1:      # no projection bias at all takes the same family
        ptrs[1] = None
        assert attn.FAMILIES[fn(L, Dh, dtype, *ptrs)] == want


# #2's backward: (L, head dim, dtype code, the pointer off 16-byte alignment,
# family): bf16 at head dim 64 up to BWD_LIMIT keys on the one-pass query
# side (then the dk dv kernel), past it and in fp32 on the three wgmma
# kernels
BWD_FAMILY_CASES = [
    (197, 64, 1, None, "long_onepass"),     # ViT-B/16, bf16
    (257, 64, 1, None, "long_onepass"),     # ViT-L/14
    (256, 64, 1, None, "long_onepass"),
    (129, 64, 1, None, "long_onepass"),     # a 1-key tail
    (144, 64, 1, None, "long_onepass"),     # a 16-key tail
    (208, 64, 1, None, "long_onepass"),
    (BWD_LIMIT, 64, 1, None, "long_onepass"),
    (BWD_LIMIT + 1, 64, 1, None, "long_wgmma"),
    (336, 64, 1, None, "long_wgmma"),
    (577, 64, 1, None, "long_wgmma"),       # ViT-L/14@336
    (4096, 64, 1, None, "long_wgmma"),
    (128, 64, 1, None, "short"),
    (257, 64, 0, None, "long_wgmma"),       # fp32: 3xTF32, three kernels
    (197, 64, 0, None, "long_wgmma"),
    (BWD_LIMIT, 64, 0, None, "long_wgmma"),
    (200, 128, 1, None, "long_mma"),
    (257, 64, 1, 0, "long_mma"),            # qkv a view at an odd offset
    (257, 64, 1, 1, "long_mma"),            # the projection bias
    (257, 64, 1, 2, "long_mma"),            # g
    (257, 64, 1, 3, "long_mma"),            # dqkv
]


@pytest.mark.parametrize("L,Dh,dtype,odd,want", BWD_FAMILY_CASES)
def test_backward_takes_the_one_pass_query_side_up_to_its_limit(rule_library, L, Dh, dtype,
                                                                odd, want):
    fn = rule_library.bwd_family
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    ptrs = [ALIGNED] * 4
    if odd is not None:
        ptrs[odd] = ODD
    assert attn.FAMILIES[fn(L, Dh, dtype, *ptrs)] == want
    if odd != 1:      # no projection bias at all takes the same family
        ptrs[1] = None
        assert attn.FAMILIES[fn(L, Dh, dtype, *ptrs)] == want


def test_backward_entry_takes_the_row_statistics_buffer(monkeypatch):
    """The backward's C entry takes a sixth pointer, the bf16 long path's
    [B, H, L, 4] fp32 statistics, which the wrapper allocates past 128
    tokens in bf16 and nowhere else."""
    class Entry:
        pass

    class Lib:
        ccmh_attention_bwd = Entry()

    monkeypatch.setattr(attn.build, "load", lambda name: Lib)
    _, fn = attn._entry("bwd")
    assert fn.argtypes == [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    stats = attn._bwd_stats(torch.zeros((3, 257, 3 * 4 * 64), dtype=torch.bfloat16), 4)
    assert stats.shape == (3, 4, 257, attn.STATS_WIDTH) == (3, 4, 257, 4)
    assert stats.dtype == torch.float32 and stats.is_contiguous()
    assert attn._bwd_stats(torch.zeros((3, 257, 3 * 4 * 64)), 4) is None           # fp32
    assert attn._bwd_stats(torch.zeros((3, 128, 3 * 4 * 64), dtype=torch.bfloat16), 4) is None


def test_wrapper_counts_a_launch_by_the_family_its_entry_reports(monkeypatch):
    calls = []

    def entry(code):
        def fn(*args):
            calls.append(args)
            return code
        return fn

    class Lib:
        ccmh_attention_fwd_family = entry(2)
        ccmh_attention_bwd_family = entry(1)

    monkeypatch.setattr(attn.build, "load", lambda name: Lib)
    assert attn._family("fwd", (16, None, 32), 257, 64, torch.bfloat16) == "long_wgmma"
    assert attn._family("bwd", (16, 48, 32, 64), 257, 64, torch.float32) == "long_mma"
    assert calls == [(16, None, 32, 257, 64, 1), (16, 48, 32, 64, 257, 64, 0)]
    Lib.ccmh_attention_bwd_family = entry(3)       # the bf16 one-pass query side
    assert attn._family("bwd", (16, 48, 32, 64), 257, 64, torch.bfloat16) == "long_onepass"
    assert len(Lib.ccmh_attention_fwd_family.argtypes) == 3 + 3
    assert len(Lib.ccmh_attention_bwd_family.argtypes) == 4 + 3
    assert attn.FAMILIES == ("short", "long_mma", "long_wgmma", "long_onepass", "long_resident")
    assert set(attn.launches_by_family) == set(attn.backward_launches_by_family) == set(
        attn.FAMILIES)


# ---- the fp32 long backward's shared-memory plan and grid

# chip_smoke.py's LONG_EDGES (with the fp32 backward's block edges 193, 320
# and 321), the towers' 197 and the C entries' longest L
PLAN_EDGES = (1, 129, 143, 144, 192, 193, 197, 208, 256, 257, 272, 273, 320, 321, 336, 337,
              577, 768, 769, 4096)
SMEM_LIMIT = 232448       # bytes a block may take on an H100


@pytest.fixture(scope="module")
def plan_library(tmp_path_factory):
    """csrc/attention_bwd32_plan.cuh built with the host compiler: kernel 2's
    (keys = 1) and kernel 3's shared memory, the blocks a head, each
    consumer's first row and rows, the stages and each stage's rows."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("plan")
    src = d / "plan.cc"
    src.write_text('#include "attention_bwd32_plan.cuh"\n'
                   'namespace p = ccmh::bwd32;\n'
                   'extern "C" int smem(int keys) { return keys ? p::kDkDvSmem : p::kDqSmem; }\n'
                   'extern "C" int consumers() { return p::kConsumers; }\n'
                   'extern "C" int blocks(int L) { return p::blocks_a_head(L); }\n'
                   'extern "C" int row0(int blk, int c) { return p::consumer_row0(blk, c); }\n'
                   'extern "C" int rows(int L, int blk, int c) {'
                   ' return p::consumer_rows(L, blk, c); }\n'
                   'extern "C" int steps(int L) { return p::stream_steps(L); }\n'
                   'extern "C" int stage_rows(int L, int s) { return p::stream_rows(L, s); }\n')
    lib = d / "plan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-I",
                    os.path.abspath(_CSRC), "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("keys,tiles_16k,stages,stage_8k,stats", [
    pytest.param(1, 4, 2, 8, 32 * 16, id="dk_dv"),    # k, k lo (2 consumers); q, g, T, lo
    pytest.param(0, 4, 3, 6, 0, id="dq"),             # q, q lo; k, v, k^T, lo
])
def test_fp32_backward_kernels_fit_a_block(plan_library, keys, tiles_16k, stages, stage_8k,
                                           stats):
    """Each kernel's shared memory, counted tile by tile (1 KB slack for the
    swizzle's 1024-byte alignment, 128 bytes of mbarriers), fits a block."""
    want = 1024 + tiles_16k * 16384 + stages * (stage_8k * 8192 + stats) + 128
    assert plan_library.smem(keys) == want <= SMEM_LIMIT


@pytest.mark.parametrize("L", PLAN_EDGES)
def test_fp32_backward_blocks_cover_each_row_once(plan_library, L):
    """The blocks' consumers hold every row of L once as a resident row,
    each at most 64, the first consumer of every block some; the stages
    stream every row once, 32 at a time."""
    seen = np.zeros(L, np.int64)
    for blk in range(plan_library.blocks(L)):
        assert plan_library.rows(L, blk, 0) > 0
        for c in range(plan_library.consumers()):
            n, r0 = plan_library.rows(L, blk, c), plan_library.row0(blk, c)
            assert 0 <= n <= 64
            seen[r0:r0 + n] += 1
    assert (seen == 1).all()
    stream = [plan_library.stage_rows(L, s) for s in range(plan_library.steps(L))]
    assert sum(stream) == L and all(0 < n <= 32 for n in stream)


# ---- the two faults: the kernels' checks refused what ccmh runs

@pytest.mark.parametrize("L", [129, 197, 257, 577])
def test_attention_kernel_check_takes_long_sequences(L):
    H, Dh = 2, 64
    qkv = torch.zeros((1, L, 3 * H * Dh))
    attn._check_kernel_inputs(qkv, causal_mask(L), H, torch.zeros(3 * H * Dh))
    with pytest.raises(ValueError, match="L <="):
        attn._check_kernel_inputs(torch.zeros((1, attn.MAX_SEQ + 1, 3 * H * Dh)), None, H, None)
    # the long backward keeps three fp32 row statistics in each row's dq slot
    narrow = torch.zeros((1, L, 3 * H * 5), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="12 bytes"):
        attn._check_kernel_inputs(narrow, None, H, None)
    attn._check_kernel_inputs(narrow[:, :attn.SHORT_SEQ].contiguous(), None, H, None)


@pytest.mark.parametrize("W", [16, 64])
def test_hamming_kernel_check_takes_long_codes(W):
    q = torch.zeros((4, W), dtype=torch.int32)
    ham._check_kernel_inputs(q, torch.zeros((9, W), dtype=torch.int32))
    wide = torch.zeros((4, ham.MAX_LANES + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="W <="):
        ham._check_kernel_inputs(wide, wide)
