"""ccmh_torch packing and Hamming distances (kernel B's wrapper) against ccmh.

Integer outputs, so every comparison is exact.  ccmh's packed popcount
kernel has no interpret path; off the TPU ccmh itself runs its plain
reference ``hamming_distance_packed_xla``, which is what these tests hold
the port to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccmh.ops.hamming import hamming_distance as jax_hamming
from ccmh.ops.hamming import hamming_distance_packed_xla
from ccmh.ops.packing import pack_codes as jax_pack, pack_codes_np, popcount32 as jax_popcount
from ccmh_torch.ops import hamming as ham
from ccmh_torch.ops.packing import pack_codes, popcount32, sign_codes, unpack_codes


def _codes(n, k, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.standard_normal((n, k)) > 0, 1, -1).astype(np.int8)


@pytest.mark.parametrize("k", [16, 31, 32, 33, 64, 70, 256])
def test_pack_codes_bit_equal_to_ccmh_uint32(k):
    codes = _codes(41, k, seed=k)
    codes[0] = 1       # every bit set: bit 31 of every lane is the int32 sign bit
    codes[1] = -1
    got = pack_codes(torch.from_numpy(codes))
    assert got.dtype == torch.int32
    lanes = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(lanes, np.asarray(jax_pack(jnp.asarray(codes))))
    np.testing.assert_array_equal(lanes, pack_codes_np(codes))
    np.testing.assert_array_equal(unpack_codes(got, k).numpy(), codes)


def test_pack_codes_of_float_signs():
    x = np.random.default_rng(0).standard_normal((9, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        pack_codes(torch.from_numpy(x)).numpy().view(np.uint32),
        np.asarray(jax_pack(jnp.asarray(x))))


def test_sign_codes_maps_zero_to_plus_one():
    got = sign_codes(torch.tensor([[-0.5, 0.0, 2.0]]))
    assert got.dtype == torch.int8 and got.tolist() == [[-1, 1, 1]]


def test_popcount32_matches_ccmh_on_all_bit_patterns():
    rng = np.random.default_rng(3)
    u = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
                        np.array([0, 1, 2**31, 2**32 - 1, 0x80000001], np.uint32)])
    got = popcount32(torch.from_numpy(u.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_popcount(jnp.asarray(u))))


@pytest.mark.parametrize("k", [16, 64, 128])
def test_int8_hamming_exact(k):
    q, r = _codes(13, k, 1), _codes(57, k, 2)
    got = ham.hamming_distance(torch.from_numpy(q), torch.from_numpy(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_hamming(jnp.asarray(q), jnp.asarray(r))))


@pytest.mark.parametrize("q_rows,n_rows,k", [(7, 301, 64), (1, 1, 16), (33, 1025, 256)])
def test_packed_hamming_exact(q_rows, n_rows, k):
    q, r = _codes(q_rows, k, 3), _codes(n_rows, k, 4)
    qp, rp = pack_codes(torch.from_numpy(q)), pack_codes(torch.from_numpy(r))
    got = ham.hamming_distance_packed(qp, rp)
    want = hamming_distance_packed_xla(jnp.asarray(qp.numpy().view(np.uint32)),
                                       jnp.asarray(rp.numpy().view(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and both equal the ±1 form
    np.testing.assert_array_equal(
        got.numpy(), ham.hamming_distance(torch.from_numpy(q), torch.from_numpy(r)).numpy())


def test_packed_wrapper_checks():
    a = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        ham.hamming_distance_packed(a.float(), a)
    with pytest.raises(ValueError):
        ham.hamming_distance_packed(a, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ham.hamming_distance_packed(a.to("meta"), a.to("meta"))
    ham.launches = 0
    ham.hamming_distance_packed(a, a)
    assert ham.launches == 0       # the CPU takes the plain version
