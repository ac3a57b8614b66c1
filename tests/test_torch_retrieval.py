"""ccmh_torch top-k retrieval and HashIndex against ccmh.

Distances and indices are integers: every comparison is exact, ties
included (equal distance -> lower gallery index first, in both packages).
"""

import os

import numpy as np
import pytest

from ccmh.retrieval import HashIndex as JaxIndex
from ccmh.retrieval import topk_search as jax_topk
from ccmh_torch.retrieval import HashIndex, topk_search
from tests.test_retrieval import brute_force, random_codes


def _index(codes, **kw):
    return HashIndex(codes, device="cpu", **kw)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("n,k_bits,k", [(500, 16, 10), (300, 64, 7), (6, 32, 50)])
def test_topk_exact_with_ties_matches_ccmh(packed, n, k_bits, k):
    g = random_codes(n, k_bits, 0)            # duplicate rows force ties
    q = random_codes(37, k_bits, 1, with_ties=False)
    q[0] = g[min(17, n - 1)]
    d, i = _index(g, packed=packed).search(q, k)
    jd, ji = JaxIndex(g, packed=packed).search(q, k)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    bd, bi = brute_force(q, g, min(k, n))
    np.testing.assert_array_equal(d, bd)
    np.testing.assert_array_equal(i, bi)
    assert d.dtype == np.int32 and i.dtype == np.int32


def test_topk_search_functional_form_and_valid_n():
    g = random_codes(200, 16, 2)
    q = random_codes(9, 16, 3, with_ties=False)
    q[1] = g[150]     # its exact match sits past valid_n and must not appear
    d, i = topk_search(q, g, 12, valid_n=120, device="cpu")
    jd, ji = jax_topk(q, g, 12, valid_n=120)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    assert i.max() < 120
    bd, bi = brute_force(q, g[:120], 12)
    np.testing.assert_array_equal(i, bi)


def test_topk_empty_queries():
    d, i = topk_search(np.empty((0, 16), np.int8), random_codes(64, 16, 4), 5,
                       device="cpu")
    assert d.shape == (0, 5) and i.shape == (0, 5)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_add_matches_ccmh_and_concatenated_gallery(packed):
    g = random_codes(1000, 64, 5)
    extra = random_codes(1500, 64, 6)          # grows past one capacity doubling
    q = random_codes(11, 64, 7, with_ties=False)
    q[2] = extra[7]
    ix, jx = _index(g, packed=packed), JaxIndex(g, packed=packed)
    for part in (extra[:20], extra[20:]):
        ix.add(part)
        jx.add(part)
    assert len(ix) == len(jx) == 2500
    d, i = ix.search(q, 9)
    jd, ji = jx.search(q, 9)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    bd, bi = brute_force(q, np.concatenate([g, extra]), 9)
    np.testing.assert_array_equal(i, bi)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("writer", ["ccmh", "port"])
def test_save_load_round_trip_across_packages(tmp_path, packed, writer):
    g = random_codes(300, 64, 8)
    labels = (np.random.RandomState(0).rand(300, 5) > 0.6).astype(np.float32)
    q = random_codes(13, 64, 9, with_ties=False)
    path = os.path.join(tmp_path, "index.npz")
    if writer == "ccmh":
        JaxIndex(g, labels=labels, packed=packed).save(path)
        loaded = HashIndex.load(path, device="cpu")
        other = JaxIndex(g, labels=labels, packed=packed)
    else:
        ix = _index(g, labels=labels, packed=packed)
        ix.add(random_codes(5, 64, 10), labels=labels[:5])
        ix.save(path)
        loaded = JaxIndex.load(path)
        other = ix
    with np.load(path) as data:
        assert data["codes"].dtype == (np.uint32 if packed else np.int8)
    assert loaded.packed == packed and len(loaded) == len(other)
    np.testing.assert_array_equal(loaded.labels, other.labels)
    for a, b in zip(loaded.search(q, 8), other.search(q, 8)):
        np.testing.assert_array_equal(a, b)


def test_precision_at_k_matches_ccmh():
    g = random_codes(200, 32, 11)
    labels = (np.random.RandomState(1).rand(200, 6) > 0.7).astype(np.float32)
    q = random_codes(15, 32, 12, with_ties=False)
    ql = (np.random.RandomState(2).rand(15, 6) > 0.7).astype(np.float32)
    assert (_index(g, labels=labels, packed=True).precision_at_k(q, ql, 10)
            == JaxIndex(g, labels=labels).precision_at_k(q, ql, 10))


def test_from_mat(tmp_path):
    import scipy.io as scio

    g = random_codes(80, 16, 13).astype(np.float64)
    path = os.path.join(tmp_path, "16-ours-synthetic-i2t.mat")
    scio.savemat(path, {"r_img": g, "r_l": np.eye(80)[:, :4]})
    ix = HashIndex.from_mat(path, device="cpu")
    q = random_codes(4, 16, 14, with_ties=False)
    np.testing.assert_array_equal(ix.search(q, 5)[1], JaxIndex.from_mat(path).search(q, 5)[1])


def test_validation_errors():
    g = random_codes(10, 16, 15, with_ties=False)
    with pytest.raises(ValueError):
        _index(g[0])                              # not 2-D
    with pytest.raises(ValueError):
        _index(g, labels=np.zeros((3, 2)))        # row mismatch
    with pytest.raises(ValueError):
        _index(g, packed=True, dist_fn=lambda a, b: a)
    ix = _index(g)
    with pytest.raises(ValueError):
        ix.add(random_codes(2, 32, 16))           # wrong width
    with pytest.raises(ValueError):
        topk_search(g, g, 3, dist_fn=lambda a, b: a, device="cpu")  # no max_dist
