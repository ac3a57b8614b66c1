"""ccmh_torch fused attention (kernel A's wrapper) against ccmh.

On the CPU the port's wrapper takes its plain version; ccmh's Pallas kernel
runs in interpret mode (``fused_attention``) and its XLA formulation
(``_xla_attention``) beside it.  Same numpy inputs through both packages.

Tolerance: fp32, atol = rtol = 1e-5 (the two packages sum the L and Dh
products in different orders; each output is a convex mix of values of
unit scale).  bf16: atol 2e-2 (a bf16 ulp at the outputs' unit scale is
7.8e-3; the probabilities and outputs are rounded to bf16 in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccmh.clip.model import causal_mask as jax_causal_mask
from ccmh.ops.attention import _xla_attention, fused_attention as jax_fused
from ccmh_torch.clip.model import causal_mask
from ccmh_torch.ops import attention as attn

CASES = [
    # (B, L, H, Dh, causal, with_qkv_b)
    pytest.param(3, 5, 2, 64, False, False, id="tiny"),
    pytest.param(3, 5, 2, 64, True, True, id="tiny-causal-bias"),
    pytest.param(2, 50, 12, 64, False, True, id="vit-b32-vision"),
    pytest.param(2, 32, 8, 64, True, True, id="vit-b32-text"),
    pytest.param(2, 77, 8, 64, True, False, id="text-l77"),
]


def _inputs(B, L, H, Dh, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, L, 3 * H * Dh).astype(np.float32)
    b = (0.5 * rng.randn(3 * H * Dh)).astype(np.float32)
    return qkv, b


@pytest.mark.parametrize("B,L,H,Dh,causal,with_b", CASES)
def test_matches_ccmh_fp32(B, L, H, Dh, causal, with_b):
    qkv, b = _inputs(B, L, H, Dh, seed=L + H)
    mask_j = jax_causal_mask(L) if causal else None
    got = attn.fused_attention(
        torch.from_numpy(qkv), causal_mask(L) if causal else None, H,
        qkv_b=torch.from_numpy(b) if with_b else None).numpy()
    want_kernel = np.asarray(jax_fused(jnp.asarray(qkv), mask_j, H,
                                       qkv_b=jnp.asarray(b) if with_b else None))
    want_xla = np.asarray(_xla_attention(
        jnp.asarray(qkv + b if with_b else qkv), mask_j, H))
    assert got.shape == (B, L, H * Dh) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=1e-5)


def test_matches_ccmh_bf16():
    B, L, H, Dh = 2, 50, 12, 64
    qkv, b = _inputs(B, L, H, Dh, seed=5)
    got = attn.fused_attention(torch.from_numpy(qkv).bfloat16(), None, H,
                               qkv_b=torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    want = jax_fused(jnp.asarray(qkv, jnp.bfloat16), None, H,
                     qkv_b=jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2)


def test_plain_version_is_differentiable_on_cpu():
    qkv, b = _inputs(2, 6, 2, 16, seed=9)
    x = torch.from_numpy(qkv).requires_grad_()
    attn.fused_attention(x, causal_mask(6), 2, qkv_b=torch.from_numpy(b)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_cpu_never_counts_a_launch():
    attn.launches = 0
    qkv, _ = _inputs(2, 5, 2, 8, seed=1)
    attn.fused_attention(torch.from_numpy(qkv), None, 2)
    assert attn.launches == 0


@pytest.mark.parametrize("qkv_shape,mask_shape,bias_shape,n_head", [
    ((2, 5, 47), None, None, 2),          # 3D not divisible by 3
    ((2, 5, 48), None, None, 5),          # D=16 not divisible by 5 heads
    ((2, 5, 48), (4, 4), None, 2),        # mask not [L, L]
    ((2, 5, 48), None, (47,), 2),         # qkv_b not [3D]
])
def test_shape_checks_raise(qkv_shape, mask_shape, bias_shape, n_head):
    with pytest.raises(ValueError):
        attn.fused_attention(
            torch.zeros(qkv_shape),
            None if mask_shape is None else torch.zeros(mask_shape), n_head,
            qkv_b=None if bias_shape is None else torch.zeros(bias_shape))


def test_other_devices_raise_instead_of_falling_back():
    with pytest.raises(ValueError, match="cuda or cpu"):
        attn.fused_attention(torch.zeros((2, 5, 48), device="meta"), None, 2)
