"""The PR and top-N precision curves (``ccmh_torch/ops/pr_curve.py``) and
the recall metrics (``ccmh_torch/ops/recall.py``) against ``ccmh``'s on the
same seeded inputs.

Tolerances: the histograms hold integer counts, so they are exactly
equal; the curves are float64 numpy on those histograms, equal within
1e-12 (the same arithmetic; the bound leaves room for another summation
order).  Inputs: ±1 codes with many ties (K=16 over ~100 items), labels
with some empty rows, so queries with no relevant item occur.
"""

import numpy as np
import pytest
import scipy.io as scio
import torch

import jax.numpy as jnp

from ccmh.ops import pr_curve as j_pr
from ccmh.ops.recall import compute_metrics as j_compute_metrics
from ccmh.train.methods.dpsih import make_dist_fn as j_make_dist_fn
from ccmh_torch.ops import pr_curve as t_pr
from ccmh_torch.ops.recall import compute_metrics
from ccmh_torch.train.methods.dpsih import make_dist_fn

K = 16
CURVE_TOL = 1e-12


def _inputs(seed, q=23, n=97, k=K, n_class=5):
    rng = np.random.RandomState(seed)
    qc = np.where(rng.rand(q, k) > 0.5, 1, -1).astype(np.int8)
    rc = np.where(rng.rand(n, k) > 0.5, 1, -1).astype(np.int8)
    ql = (rng.rand(q, n_class) > 0.7).astype(np.float32)
    rl = (rng.rand(n, n_class) > 0.7).astype(np.float32)
    ql[:3] = 0                       # queries with no relevant item
    return qc, rc, ql, rl


def _assert_hists_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("chunk", [None, 0, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hists_and_curves_match_ccmh(seed, chunk):
    qc, rc, ql, rl = _inputs(seed)
    got = t_pr.compute_hists(qc, rc, ql, rl, chunk=chunk, device="cpu")
    want = j_pr.compute_hists(qc, rc, ql, rl, chunk=chunk)
    _assert_hists_equal(got, want)
    assert (got[2] == 0).sum() >= 3

    p, r = t_pr.pr_curve(qc, rc, ql, rl, chunk=chunk, device="cpu")
    jp, jr = j_pr.pr_curve(qc, rc, ql, rl, chunk=chunk)
    assert p.shape == r.shape == (K + 1,)
    np.testing.assert_allclose(p, jp, rtol=0, atol=CURVE_TOL)
    np.testing.assert_allclose(r, jr, rtol=0, atol=CURVE_TOL)
    assert r[-1] == pytest.approx(1.0)            # everything within radius K

    ns = [1, 5, 10, 50, 97]
    got_p = t_pr.precision_at_n(qc, rc, ql, rl, ns, chunk=chunk, device="cpu")
    want_p = j_pr.precision_at_n(qc, rc, ql, rl, ns, chunk=chunk)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=CURVE_TOL)
    # hists= reuses one pass
    np.testing.assert_array_equal(
        t_pr.precision_at_n(qc, rc, ql, rl, ns, hists=got), got_p)


def test_empty_queries():
    qc, rc, ql, rl = _inputs(3)
    got = t_pr.compute_hists(qc[:0], rc, ql[:0], rl, device="cpu")
    want = j_pr.compute_hists(qc[:0], rc, ql[:0], rl)
    assert [g.shape for g in got] == [(0, K + 1), (0, K + 1), (0,)]
    _assert_hists_equal(got, want)
    p, r = t_pr.pr_curve(qc[:0], rc, ql[:0], rl, device="cpu")
    np.testing.assert_array_equal(p, np.zeros(K + 1))
    np.testing.assert_array_equal(r, np.zeros(K + 1))


def test_custom_dist_fn_with_max_dist():
    """DPSIH's multi-embed ranking: codes [B, 4K], distances in [0, K]."""
    rng = np.random.RandomState(4)
    qc = np.where(rng.rand(19, 4 * K) > 0.5, 1, -1).astype(np.int8)
    rc = np.where(rng.rand(61, 4 * K) > 0.5, 1, -1).astype(np.int8)
    ql = (rng.rand(19, 4) > 0.6).astype(np.float32)
    rl = (rng.rand(61, 4) > 0.6).astype(np.float32)
    with pytest.raises(ValueError, match="max_dist"):
        t_pr.compute_hists(qc, rc, ql, rl, dist_fn=make_dist_fn(K), device="cpu")
    got = t_pr.compute_hists(qc, rc, ql, rl, dist_fn=make_dist_fn(K), max_dist=K,
                             chunk=5, device="cpu")
    want = j_pr.compute_hists(qc, rc, ql, rl, dist_fn=j_make_dist_fn(K), max_dist=K, chunk=5)
    _assert_hists_equal(got, want)
    np.testing.assert_allclose(t_pr.pr_curve(qc, rc, ql, rl, hists=got),
                               j_pr.pr_curve(qc, rc, ql, rl, hists=want),
                               rtol=0, atol=CURVE_TOL)


def test_cli_round_trip_on_a_ccmh_dump(tmp_path):
    """A reference-layout ``.mat`` (float64 codes, as ``save_mat`` writes
    them) through both CLIs."""
    qc, rc, ql, rl = _inputs(5)
    rng = np.random.RandomState(6)
    rc_img = np.where(rng.rand(*rc.shape) > 0.5, 1, -1)
    mat = str(tmp_path / "16-ours-synthetic-i2t.mat")
    scio.savemat(mat, {"q_img": qc.astype(np.float64), "q_txt": -qc.astype(np.float64),
                       "r_img": rc_img.astype(np.float64), "r_txt": rc.astype(np.float64),
                       "q_l": ql, "r_l": rl})
    for direction in ("i2t", "t2i"):
        want_path, got_path = str(tmp_path / f"j-{direction}.mat"), str(tmp_path / f"t-{direction}.mat")
        assert j_pr._main([mat, "--direction", direction, "-o", want_path]) == 0
        assert t_pr.main([mat, "--direction", direction, "-o", got_path,
                          "--device", "cpu"]) == 0
        got, want = scio.loadmat(got_path), scio.loadmat(want_path)
        for key in ("radius", "topn"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in ("precision", "recall", "p_at_n"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=CURVE_TOL,
                                       err_msg=f"{direction} {key}")
    out = str(tmp_path / "topn.mat")
    assert t_pr.main([mat, "--topn", "1,3,9", "-o", out, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(scio.loadmat(out)["topn"].ravel(), [1, 3, 9])


@pytest.mark.parametrize("seed", [0, 1])
def test_recall_metrics_match_ccmh(seed):
    rng = np.random.RandomState(seed)
    sim = rng.randn(40, 40).astype(np.float32)
    sim[np.arange(40), np.arange(40)] += rng.rand(40).astype(np.float32) * 2
    got = compute_metrics(torch.from_numpy(sim))
    assert got == j_compute_metrics(jnp.asarray(sim))
    assert compute_metrics(sim) == got
