"""The attention backward (kernel C's plain version) and autograd through
the port's ``fused_attention`` against ``jax.vjp`` of ccmh's.

On the CPU the port's ``FusedAttention`` takes the plain forward and
backward; ccmh's ``fused_attention`` runs its Pallas backward in interpret
mode, and the XLA formulation (``_xla_attention`` on ``qkv + qkv_b``) is
differentiated beside it.  Same numpy inputs and cotangent through both.

Tolerance: fp32 atol 1e-5 x the cotangent's scale (the frameworks sum the
L and Dh products in other orders; every gradient here is O(1)); bf16
atol 2e-2 x max(1, max |dqkv|) (q, k, v, g, the probabilities and dlogits
are rounded to bf16 at the same points in both, a bf16 ulp at unit scale
is 7.8e-3, and a rounding that falls the other way moves one product
term by that much).  ``d qkv_b`` is the (B, L) sum of ``dqkv`` in both,
held to the same tolerances times sqrt(B L).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.clip.model import causal_mask as jax_causal_mask
from ccmh.ops.attention import _xla_attention, fused_attention as jax_fused
from ccmh_torch.clip.model import causal_mask
from ccmh_torch.ops import attention as attn

CASES = [
    # (B, L, H, Dh, causal, with_qkv_b)
    pytest.param(3, 5, 2, 16, False, False, id="tiny"),
    pytest.param(3, 5, 2, 16, True, True, id="tiny-causal-bias"),
    pytest.param(2, 9, 3, 8, False, True, id="tiny-bias"),
    pytest.param(1, 50, 12, 64, False, True, id="vit-b32-vision"),
    pytest.param(1, 32, 8, 64, True, True, id="vit-b32-text"),
]


def _inputs(B, L, H, Dh, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, L, 3 * H * Dh).astype(np.float32)
    b = (0.5 * rng.randn(3 * H * Dh)).astype(np.float32)
    g = rng.randn(B, L, H * Dh).astype(np.float32)
    return qkv, b, g


def _jax_grads(fn, qkv, b, g, dtype, with_b):
    args = (jnp.asarray(qkv, dtype),) + ((jnp.asarray(b, dtype),) if with_b else ())
    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g, out.dtype))
    return [np.asarray(x, np.float32) for x in grads]


def _port_grads(qkv, b, g, H, causal, dtype, with_b):
    L = qkv.shape[1]
    x = torch.from_numpy(qkv).to(dtype).requires_grad_()
    bias = torch.from_numpy(b).to(dtype).requires_grad_() if with_b else None
    out = attn.fused_attention(x, causal_mask(L) if causal else None, H, qkv_b=bias)
    out.backward(torch.from_numpy(g).to(dtype))
    grads = [x.grad] + ([bias.grad] if with_b else [])
    return [t.float().numpy() for t in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,Dh,causal,with_b", CASES)
def test_backward_matches_ccmh(B, L, H, Dh, causal, with_b, dtype):
    qkv, b, g = _inputs(B, L, H, Dh, seed=L * 7 + H)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    mask_j = jax_causal_mask(L) if causal else None

    def pallas(x, *bb):
        return jax_fused(x, mask_j, H, qkv_b=bb[0] if bb else None)

    def xla(x, *bb):
        return _xla_attention(x + bb[0].astype(x.dtype) if bb else x, mask_j, H)

    want_kernel = _jax_grads(pallas, qkv, b, g, jdt, with_b)
    want_xla = _jax_grads(xla, qkv, b, g, jdt, with_b)

    # the plain backward alone, and autograd through the Function
    ref = attn.attention_backward_reference(
        torch.from_numpy(qkv).to(tdt), causal_mask(L) if causal else None,
        torch.from_numpy(b).to(tdt) if with_b else None, torch.from_numpy(g).to(tdt), H)
    assert ref.dtype == tdt and tuple(ref.shape) == (B, L, 3 * H * Dh)
    got = _port_grads(qkv, b, g, H, causal, tdt, with_b)
    np.testing.assert_array_equal(got[0], ref.float().numpy())

    scale = max(1.0, float(np.abs(want_kernel[0]).max()))
    tol = 1e-5 if dtype == "float32" else 2e-2 * scale
    for want in (want_kernel, want_xla):
        np.testing.assert_allclose(got[0], want[0], atol=tol, rtol=0)
        if with_b:
            np.testing.assert_allclose(got[1], want[1], atol=tol * math.sqrt(B * L), rtol=0)
            # d qkv_b is the (B, L) sum of dqkv
            np.testing.assert_allclose(got[1], got[0].sum((0, 1)), atol=tol * math.sqrt(B * L))


def test_mask_gets_no_gradient_and_forward_saves_raw_qkv():
    qkv, b, g = _inputs(2, 6, 2, 8, seed=3)
    x = torch.from_numpy(qkv).requires_grad_()
    mask = causal_mask(6).requires_grad_()
    out = attn.fused_attention(x, mask, 2, qkv_b=torch.from_numpy(b))
    # the saved residuals are the raw inputs, as ccmh's _fwd keeps them
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and saved[0].data_ptr() == x.data_ptr()
    out.backward(torch.from_numpy(g))
    assert mask.grad is None and x.grad is not None


def test_cpu_never_counts_a_launch():
    attn.launches = attn.backward_launches = 0
    qkv, b, g = _inputs(2, 5, 2, 8, seed=1)
    x = torch.from_numpy(qkv).requires_grad_()
    attn.fused_attention(x, None, 2).backward(torch.from_numpy(g))
    attn.attention_backward(torch.from_numpy(qkv), None, None, torch.from_numpy(g), 2)
    assert attn.launches == 0 and attn.backward_launches == 0


@pytest.mark.parametrize("g_shape,device", [((2, 5, 15), "cpu"), ((2, 5, 16), "meta")])
def test_backward_checks_raise(g_shape, device):
    qkv = torch.zeros((2, 5, 48), device=device)
    with pytest.raises(ValueError):
        attn.attention_backward(qkv, None, None, torch.zeros(g_shape, device=device), 2)
