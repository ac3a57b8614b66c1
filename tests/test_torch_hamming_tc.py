"""The tensor-core family of the packed Hamming kernel #3
(``ccmh_torch/csrc/hamming.cu``) on the CPU: its arithmetic, emulated in
numpy as the kernel does it, held exactly to ``ccmh``'s plain packed
reference, and the fixed rule by which its C entry picks a family.

The kernel needs the card (no ``nvcc`` here).  What these tests reach is
its formulation and its index arithmetic: popc(q ^ r) = popc(q) +
popc(r) - 2 popc(q & r), the AND-popcount sum over 256-bit k-steps of 8
lanes with zero-filled tails, the tiles of 128 x 128 with ragged Q and N,
the lanes' places in the 128-byte swizzled tiles that the products and
the row popcounts read, and the m64n128 accumulator fragments staged
through the swizzled [64][128] int32 tile and stored by whole rows.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.ops.hamming import hamming_distance_packed_xla
from ccmh_torch.ops import hamming as ham
from ccmh_torch.tools import time_hamming as th

_CSRC = os.path.join(os.path.dirname(ham.__file__), os.pardir, "csrc")
TILE = 128            # query rows = gallery rows of a block
KSTEP_LANES = 8       # 256 bits
ATOM_LANES = 32       # a 128-byte swizzle row
ATOM_BYTES = TILE * 128
_xla = jax.jit(hamming_distance_packed_xla)   # one compile a shape, not one an op


def lane_offset(r, l):
    """Byte offset of lane l of row r in a landed tile (hamming.cu)."""
    return (l >> 5) * ATOM_BYTES + r * 128 + ((((l & 31) >> 2) ^ (r & 7)) << 4) + ((l & 3) << 2)


def land(rows: np.ndarray, W: int) -> np.ndarray:
    """A tile of up to 128 rows of W lanes as TMA (or the lane loader)
    lands it: uint8 bytes of two atoms, rows and lanes past the data 0."""
    tile = np.zeros(2 * ATOM_BYTES, np.uint8)
    n = rows.shape[0]
    r_idx, l_idx = np.meshgrid(np.arange(TILE), np.arange(2 * ATOM_LANES), indexing="ij")
    vals = np.zeros((TILE, 2 * ATOM_LANES), np.uint32)
    vals[:n, :W] = rows
    off = lane_offset(r_idx, l_idx)
    for b in range(4):
        tile[off + b] = ((vals >> (8 * b)) & 0xFF).astype(np.uint8)
    return tile


def kstep(tile: np.ndarray, first_row: int, n_rows: int, ks: int) -> np.ndarray:
    """The [n_rows][8] uint32 lanes a k-step descriptor reads: atom ks //
    4, logical 16-byte chunks 2 (ks % 4) and 2 (ks % 4) + 1 of each row at
    their swizzled places."""
    rows = first_row + np.arange(n_rows)[:, None]
    c = 2 * (ks & 3) + np.arange(2)[None, :]
    at = (ks >> 2) * ATOM_BYTES + rows * 128 + ((c ^ (rows & 7)) << 4)
    chunks = np.ascontiguousarray(tile[at[..., None] + np.arange(16)])
    return chunks.view(np.uint32).reshape(n_rows, KSTEP_LANES)


def row_popcounts(tile: np.ndarray, KS: int) -> np.ndarray:
    """Each row's set bits over the 2 KS chunks the k-steps read."""
    rows = np.arange(TILE)[:, None]
    c = np.arange(2 * KS)[None, :]
    at = (c >> 3) * ATOM_BYTES + rows * 128 + (((c & 7) ^ (rows & 7)) << 4)
    return np.bitwise_count(tile[at[..., None] + np.arange(16)]).astype(np.int32).sum((1, 2))


# the m64n128 s32 accumulator fragment of thread (warp w, lane): d[4 j + e]
# is row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
_W, _LANE, _J, _E = np.meshgrid(np.arange(4), np.arange(32), np.arange(16), np.arange(4),
                                indexing="ij")
FRAG_ROW = 16 * _W + (_LANE >> 2) + 8 * (_E >> 1)
FRAG_COL = 8 * _J + 2 * (_LANE & 3) + (_E & 1)


def emulate(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """The tensor-core kernel's result for uint32 lanes q [Q, W], r [N, W]."""
    Q, W = q.shape
    N = r.shape[0]
    KS = -(-W // KSTEP_LANES)
    out = np.full((Q, N), -1, np.int64)
    for q0 in range(0, Q, TILE):
        for n0 in range(0, N, TILE):
            qt, rt = land(q[q0:q0 + TILE], W), land(r[n0:n0 + TILE], W)
            pq, pr = row_popcounts(qt, KS), row_popcounts(rt, KS)
            for wg in range(2):          # a warpgroup's 64 query rows
                acc = np.zeros((64, TILE), np.int32)
                for ks in range(KS):
                    a, b = kstep(qt, 64 * wg, 64, ks), kstep(rt, 0, TILE, ks)
                    acc += np.bitwise_count(a[:, None, :] & b[None, :, :]).astype(
                        np.int32).sum(-1)
                # the fragments through the staging tile: row rr at rr * 512,
                # 16-byte chunk c at c ^ (rr & 7); then read back by rows
                frag = acc[FRAG_ROW, FRAG_COL]
                d = pq[64 * wg + FRAG_ROW] + pr[FRAG_COL] - 2 * frag
                stage = np.zeros(64 * TILE, np.int32)
                stage[FRAG_ROW * TILE + (((FRAG_COL >> 2) ^ (FRAG_ROW & 7)) << 2)
                      + (FRAG_COL & 3)] = d
                for rr in range(64):
                    gq = q0 + 64 * wg + rr
                    if gq >= Q:
                        break
                    cols = np.arange(TILE)
                    row = stage[rr * TILE + (((cols >> 2) ^ (rr & 7)) << 2) + (cols & 3)]
                    n = min(TILE, N - n0)
                    out[gq, n0:n0 + n] = row[:n]
    return out


def _lanes(rows, W, seed):
    """Seeded random lanes with the edge patterns in the first rows: all
    zero, all one, the sign bit alone, and the sign bit clear."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint64).astype(np.uint32)
    for i, v in enumerate((0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)):
        if i < rows:
            x[i] = v
    return x


@pytest.mark.parametrize("W,Q,N", [(1, 3, 5), (2, 130, 7), (4, 9, 129), (7, 1, 130),
                                   (8, 17, 33), (9, 129, 3), (16, 5, 131), (17, 64, 65),
                                   (33, 7, 140), (63, 11, 9), (64, 130, 12)])
def test_tensor_core_arithmetic_equals_ccmh(W, Q, N):
    q, r = _lanes(Q, W, seed=W), _lanes(N, W, seed=100 + W)
    want = np.asarray(_xla(jnp.asarray(q), jnp.asarray(r)))
    got = emulate(q, r)
    np.testing.assert_array_equal(got, want)
    # the port's plain version, which the kernel is held to on the card
    np.testing.assert_array_equal(
        ham.hamming_distance_packed(torch.from_numpy(q.view(np.int32)),
                                    torch.from_numpy(r.view(np.int32))).numpy(), want)


@pytest.fixture(scope="module")
def family_rule(tmp_path_factory):
    """The C entry's family rule (csrc/hamming_family.cuh), built with the
    host compiler into a small library: (family, tma_ok)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("hamming_family")
    src = d / "family.cc"
    src.write_text('#include "hamming_family.cuh"\n'
                   'extern "C" int family(int W, const void* q, const void* r) {\n'
                   '  return ccmh::hamming_family(W, q, r);\n}\n'
                   'extern "C" int tma_ok(int W, const void* q, const void* r) {\n'
                   '  return ccmh::hamming_tma_ok(W, q, r);\n}\n')
    lib = d / "family.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-I",
                    os.path.abspath(_CSRC), "-o", str(lib), str(src)], check=True)
    fns = ctypes.CDLL(str(lib))
    for fn in (fns.family, fns.tma_ok):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fns.family, fns.tma_ok


ALIGNED, ODD = 1 << 20, (1 << 20) + 4        # addresses only: the rule reads no memory


@pytest.mark.parametrize("W,q_at,r_at,want", [
    (1, ALIGNED, ALIGNED, "lanes"), (2, ODD, ODD, "lanes"), (4, ALIGNED, ALIGNED, "lanes"),
    (8, ALIGNED, ALIGNED, "lanes"), (9, ALIGNED, ALIGNED, "lanes"),
    (12, ALIGNED, ALIGNED, "tma"), (16, ALIGNED, ALIGNED, "tma"),
    (17, ALIGNED, ALIGNED, "lanes"), (33, ALIGNED, ALIGNED, "lanes"),
    (64, ALIGNED, ALIGNED, "tma"), (64, ODD, ALIGNED, "lanes"), (16, ALIGNED, ODD, "lanes"),
])
def test_family_rule_by_lanes(family_rule, W, q_at, r_at, want):
    assert ham.FAMILIES[family_rule[0](W, q_at, r_at)] == want


def test_tma_takes_only_rows_of_16_byte_multiples_at_aligned_starts(family_rule):
    # the entry refuses a forced tma launch where this is false, and the
    # rule takes tma only where it is true and the code is past 256 bits
    family, tma_ok = family_rule
    for W in range(1, ham.MAX_LANES + 1):
        for q_at, r_at in ((ALIGNED, ALIGNED), (ODD, ALIGNED), (ALIGNED, ODD)):
            ok = bool(tma_ok(W, q_at, r_at))
            assert ok == (W % 4 == 0 and q_at == r_at == ALIGNED)
            assert ham.FAMILIES[family(W, q_at, r_at)] == ("tma" if ok and W > 8 else "lanes")


@pytest.mark.parametrize("reported", [0, 1])
def test_wrapper_counts_a_launch_by_the_family_its_entry_reports(monkeypatch, reported):
    calls = []

    def entry(*args):
        calls.append(args[:8])
        args[8].contents.value = reported
        return 0

    class Lib:
        ccmh_hamming_packed_as = entry

    monkeypatch.setattr(ham.build, "load", lambda name: Lib)
    monkeypatch.setattr(ham, "launches", 0)
    monkeypatch.setattr(ham, "launches_by_family", dict.fromkeys(ham.FAMILIES, 0))
    q, r = torch.zeros((3, 16), dtype=torch.int32), torch.zeros((5, 16), dtype=torch.int32)
    out = torch.empty((3, 5), dtype=torch.int32)
    assert ham._launch(q, r, out, 0) == ham.FAMILIES[reported]
    # the rule's code -1: the entry, not the wrapper, picks the family
    assert calls == [(None, q.data_ptr(), r.data_ptr(), out.data_ptr(), 3, 5, 16, -1)]
    assert ham.launches == 1
    assert ham.launches_by_family == {f: int(i == reported) for i, f in enumerate(ham.FAMILIES)}


@pytest.mark.parametrize("Q,N,W", [(512, 2 ** 18, 2), (512, 2 ** 18, 16), (512, 2 ** 18, 64),
                                   (500, 2 ** 18 + 37, 17)])
def test_bound_counts_bytes_and_one_bit_operations(Q, N, W):
    # the one-bit product at 8x the int8 dense rate: the int32 output's
    # bytes bound every length the kernel takes
    ms, by, popc_ms = th.bound(Q, N, W)
    k_padded = -(-32 * W // 256) * 256
    t_bytes = (Q * W + N * W + Q * N) * 4 / 3.35e12
    t_ops = 2.0 * Q * N * k_padded / (8 * 1979e12)
    assert th.PEAK_OPS_PER_S["b1"] == 8 * th.PEAK_OPS_PER_S["int8"] == 8 * 1979e12
    assert by == "bytes" and t_bytes > t_ops
    assert ms == pytest.approx(1e3 * t_bytes)
    assert popc_ms == pytest.approx(1e3 * Q * N * W / (132 * 16 * 1.98e9))
