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
* The long kernels' schedule emulated in plain PyTorch, against ccmh: the
  keys in 64-row tiles taken 32 columns at a time, each row's max and sum
  streamed and the sum rescaled as the max grows, the probabilities
  normalised in fp32 before they are rounded to T, the backward's D_i
  streamed with the same rescale over the unrounded probabilities, dq
  summed query-major and dk, dv key-major; fp32 products as 3xTF32 split
  toward zero.  The card holds the kernels to fp32 1e-4 and bf16 2e-2
  (``chip_smoke.py``); the emulation sits 10x under the fp32 gate and
  within the bf16 gate.
* The two faults found on the card: the kernels' checks refused L > 128
  and codes of more than 256 bits.
"""

import math

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

TILE, CHUNK = 64, 32      # the long kernels' key tile and logit chunk
GATE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # the card's gates
MARGIN = 10.0             # the emulated fp32 chain sits this far under its gate

CASES = [
    # (B, L, H, Dh, mask)
    pytest.param(2, 129, 2, 64, "causal", id="L129-causal"),
    pytest.param(2, 197, 2, 32, "none", id="L197-vitb16"),
    pytest.param(1, 257, 2, 64, "pad", id="L257-keypad"),
]


def _mask(L, kind, jax_side=False):
    if kind == "causal":
        return jax_causal_mask(L) if jax_side else causal_mask(L)
    if kind == "pad":
        m = np.zeros((L, L), np.float32)
        m[:, L - L // 3:] = -np.inf          # the last third of the keys padded
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


def _mm(a, b, dtype):
    """A product as the kernels take it: bf16 values multiplied exactly and
    summed in fp32; fp32 as 3xTF32 split toward zero."""
    if dtype == torch.bfloat16:
        return a @ b
    (ah, al), (bh, bl) = _split_tz(a), _split_tz(b)
    return al @ bh + ah @ bl + ah @ bh


def _heads(qkv, b, H, dtype):
    B, L, D3 = qkv.shape
    x = (qkv + b).to(dtype).float()       # the bias folded in T
    return x.reshape(B, L, 3, H, D3 // 3 // H).permute(2, 0, 3, 1, 4)   # [B, H, L, Dh]


def _logits(q, k, cols, mask, dtype, scale):
    s = _mm(q, k[..., cols, :].transpose(-1, -2), dtype) * scale
    return s + mask[:, cols] if mask is not None else s


def _chunks(L):
    for k0 in range(0, L, TILE):
        for n0 in range(k0, min(k0 + TILE, L), CHUNK):
            yield slice(n0, min(n0 + CHUNK, L))


def _stats(q, k, v, gh, mask, dtype, scale):
    """Pass 1: each row's max, sum and (with gh) D numerator, streamed."""
    mx = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    dn = torch.zeros(q.shape[:-1])
    for cols in _chunks(q.shape[-2]):
        s = _logits(q, k, cols, mask, dtype, scale)
        nm = torch.maximum(mx, s.amax(-1))
        corr = torch.where(mx == -math.inf, torch.zeros(()), torch.exp(mx - nm))
        p = torch.exp(s - nm[..., None])
        l = l * corr + p.sum(-1)
        if gh is not None:
            dn = dn * corr + (p * _mm(gh, v[..., cols, :].transpose(-1, -2), dtype)).sum(-1)
        mx = nm
    return mx, l, dn


def forward_long(qkv, b, mask, H, dtype):
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    mx, l, _ = _stats(q, k, v, None, mask, dtype, scale)
    ctx = torch.zeros_like(q)
    for cols in _chunks(L):
        p = torch.exp(_logits(q, k, cols, mask, dtype, scale) - mx[..., None]) * (1.0 / l)[..., None]
        ctx = ctx + _mm(p.to(dtype).float(), v[..., cols, :], dtype)
    return ctx.permute(0, 2, 1, 3).reshape(B, L, H * Dh).to(dtype)


def backward_long(qkv, b, mask, g, H, dtype):
    q, k, v = _heads(qkv, b, H, dtype)
    B, _, L, Dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    gh = g.to(dtype).float().reshape(B, L, H, Dh).permute(0, 2, 1, 3)
    mx, l, dn = _stats(q, k, v, gh, mask, dtype, scale)
    inv = 1.0 / l
    d = dn * inv

    def p_ds(rows, cols):
        """p and dS scale of queries ``rows`` against keys ``cols``."""
        s = _mm(q[..., rows, :], k[..., cols, :].transpose(-1, -2), dtype) * scale
        if mask is not None:
            s = s + mask[rows, cols]
        p = torch.exp(s - mx[..., rows, None]) * inv[..., rows, None]
        dp = _mm(gh[..., rows, :], v[..., cols, :].transpose(-1, -2), dtype)
        return p, p * (dp - d[..., rows, None]) * scale

    everyone = slice(0, L)
    dq = torch.zeros_like(q)          # phase 1, query-major: dq over the key chunks
    for cols in _chunks(L):
        _, ds = p_ds(everyone, cols)
        dq = dq + _mm(ds.to(dtype).float(), k[..., cols, :], dtype)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)   # phase 2, key-major
    for rows in _chunks(L):
        p, ds = p_ds(rows, everyone)
        dv = dv + _mm(p.to(dtype).float().transpose(-1, -2), gh[..., rows, :], dtype)
        dk = dk + _mm(ds.to(dtype).float().transpose(-1, -2), q[..., rows, :], dtype)
    out = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4)
    return out.reshape(B, L, 3 * H * Dh).to(dtype)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,L,H,Dh,kind", CASES)
def test_long_schedule_matches_ccmh(B, L, H, Dh, kind, dtype, direction):
    qkv, b, g = _port_inputs(B, L, H, Dh, dtype)
    out, dqkv = _ccmh(B, L, H, Dh, kind, dtype)
    mask = _mask(L, kind)
    if direction == "forward":
        got, want, scale = forward_long(qkv, b, mask, H, dtype), out, 1.0
    else:
        got, want = backward_long(qkv, b, mask, g, H, dtype), dqkv
        scale = max(1.0, float(np.abs(dqkv).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    gate = GATE[dtype] * scale / (MARGIN if dtype == torch.float32 else 1.0)
    assert math.isfinite(err) and err <= gate, (err, gate)


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
