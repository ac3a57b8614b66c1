"""The port's mAP (``calc_map`` exact and hist, ``calc_map_4way``) against
ccmh's on random ±1 codes with heavy ties.

The ranking of the exact method is integer work and must be ccmh's
exactly: ties in gallery index order, the same relevance sequence.  The
mAP values are float32 sums of the per-position precisions, which the two
frameworks add in other orders, so they are held to 4 float32 ulps of an
mAP in (0, 1) (atol 5e-7); hist values within 1e-6 (digamma and the
per-bin float32 arithmetic).
"""

import numpy as np
import pytest
import torch

from ccmh.ops.map_metric import calc_map as jax_calc_map, calc_map_4way as jax_4way
from ccmh_torch.ops import map_metric
from ccmh_torch.ops.map_metric import calc_map, calc_map_4way

CASES = [  # (K, queries, gallery, classes)
    (16, 50, 300, 5),
    (8, 37, 1000, 4),
    (64, 100, 2000, 10),
    (4, 300, 3000, 3),
]


def _data(K, Q, N, C, seed):
    rng = np.random.RandomState(seed)
    q = np.where(rng.rand(Q, K) < 0.5, -1, 1).astype(np.int8)
    r = np.where(rng.rand(N, K) < 0.5, -1, 1).astype(np.int8)
    r[::3] = r[0]                       # a third of the gallery ties
    q[::4] = r[0]                       # and a quarter of the queries sit on it
    ql = (rng.rand(Q, C) < 0.3).astype(np.float32)
    rl = (rng.rand(N, C) < 0.3).astype(np.float32)
    ql[::5] = 0                         # queries with no relevant item count as 0
    return q, r, ql, rl


@pytest.mark.parametrize("K,Q,N,C", CASES)
@pytest.mark.parametrize("method,k", [("exact", None), ("exact", 20), ("hist", None)])
def test_calc_map_matches_ccmh(K, Q, N, C, method, k):
    q, r, ql, rl = _data(K, Q, N, C, seed=K + Q)
    want = float(jax_calc_map(q, r, ql, rl, k=k, method=method))
    got = calc_map(q, r, ql, rl, k=k, method=method, device="cpu").item()
    np.testing.assert_allclose(got, want, atol=5e-7 if method == "exact" else 1e-6, rtol=0)
    # chunking the queries does not change the value
    chunked = calc_map(q, r, ql, rl, k=k, method=method, chunk=7, device="cpu").item()
    np.testing.assert_allclose(chunked, got, atol=5e-7, rtol=0)


def test_exact_ranking_is_stable_by_gallery_index(monkeypatch):
    """The sorted relevance rows inside the exact method equal numpy's
    stable argsort of the distances, with the key packing and without."""
    q, r, ql, rl = _data(16, 20, 500, 4, seed=1)
    dist = (16 - q.astype(np.int32) @ r.astype(np.int32).T) // 2
    gnd = ((ql @ rl.T) > 0).astype(np.int32)
    want = np.take_along_axis(gnd, np.argsort(dist, axis=1, kind="stable"), axis=1)
    seen = []
    real_cumsum = torch.cumsum

    def spy(x, dim):
        seen.append(x.clone())
        return real_cumsum(x, dim=dim)

    monkeypatch.setattr(map_metric.torch, "cumsum", spy)
    calc_map(q, r, ql, rl, method="exact", device="cpu")
    np.testing.assert_array_equal(seen[-1].numpy(), want)
    # the two-operand stable sort (a gallery too large for the packed key)
    monkeypatch.setattr(map_metric, "_KEY_BITS", 8)
    calc_map(q, r, ql, rl, method="exact", device="cpu")
    np.testing.assert_array_equal(seen[-1].numpy(), want)


def test_calc_map_4way_matches_ccmh():
    q, r, ql, rl = _data(32, 60, 800, 6, seed=4)
    qt = -q
    rt = np.roll(r, 1, axis=0)
    want = [float(x) for x in jax_4way(q, qt, r, rt, ql, rl)]
    got = [x.item() for x in calc_map_4way(q, qt, r, rt, ql, rl, device="cpu")]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    exact = [x.item() for x in calc_map_4way(q, qt, r, rt, ql, rl, method="exact",
                                             device="cpu")]
    want_exact = [float(x) for x in jax_4way(q, qt, r, rt, ql, rl, method="exact")]
    np.testing.assert_allclose(exact, want_exact, atol=5e-7, rtol=0)


def test_hist_refuses_a_cutoff():
    q, r, ql, rl = _data(8, 4, 10, 2, seed=0)
    with pytest.raises(ValueError, match="mAP@all"):
        calc_map(q, r, ql, rl, k=5, method="hist", device="cpu")
