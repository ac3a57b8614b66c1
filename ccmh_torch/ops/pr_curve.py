"""Precision-recall and top-N precision curves of a Hamming ranking (port of
``ccmh/ops/pr_curve.py``).

The reference never computes these curves: it dumps the codes and labels
to ``PR_cruve/*.mat`` (train/base.py:328-349) for users to plot with their
own scripts.  Both curves come from one pass over the distances:

* :func:`compute_hists` — per query, the items ``A`` and relevant items
  ``R`` at each distance, and the relevant total ``tsum``, on the device
  in query chunks (the histograms of the sort-free mAP,
  ``map_metric._bin_counts``), returned as float32 numpy arrays whose
  values are integers;
* :func:`pr_curve` — precision and recall at every radius r in [0, K]:
  P(r) = relevant within r / retrieved within r (0 when nothing is),
  R(r) = relevant within r / all relevant, each averaged over the queries
  with at least one relevant item (calc_map_k's skip-empty convention,
  utils/calc_utils.py:33-35);
* :func:`precision_at_n` — mean P@N, the expectation over random orders
  of tied items: a distance group of A_d items (R_d relevant) at ranks
  (L_d, L_d + A_d] puts R_d * clip(N - L_d, 0, A_d) / A_d relevant items
  into the top N (the histogram mAP's tie semantics; exact on tie-free
  rankings).

The curves are float64 numpy, ``ccmh``'s arithmetic on the same
histograms.  Distances are the ±1 matmul (``hamming_distance``) or a
method's own ``dist_fn`` with its ``max_dist``.  The port runs eagerly,
so the last chunk takes its true size and needs no padding.

CLI, on a reference-layout code dump::

    python -m ccmh_torch.ops.pr_curve PR_cruve/64-ours-coco-i2t.mat \
        --direction i2t -o curves.mat [--topn 1,10,100] [--device cuda]
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ccmh_torch.device import DeviceLike, resolve_device
from ccmh_torch.ops.hamming import hamming_distance
from ccmh_torch.ops.map_metric import (
    DistFn, _as_tensor, _bin_counts, _chunk_budget_elems, _gnd_matrix,
)

Hists = Tuple[np.ndarray, np.ndarray, np.ndarray]


def compute_hists(q_codes, r_codes, q_labels, r_labels, chunk: Optional[int] = None,
                  dist_fn: Optional[DistFn] = None, max_dist: Optional[int] = None,
                  device: Optional[DeviceLike] = None) -> Hists:
    """(A, R, tsum): [Q, max_dist + 1], [Q, max_dist + 1] and [Q] float32
    numpy, the shared input of both curves (pass it as ``hists=`` to
    :func:`pr_curve` and :func:`precision_at_n` to run the [Q, N]
    distance pass once).  ``chunk`` None or <= 0 sizes the [chunk, N]
    working set from the device's memory, between 64 and 2048 queries.
    ``device`` defaults to the codes' device for a tensor, else cuda."""
    if device is None:
        device = q_codes.device if isinstance(q_codes, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    num_query, k = q_codes.shape[0], q_codes.shape[1]
    if max_dist is None:
        if dist_fn is not None:
            raise ValueError("custom dist_fn requires max_dist")
        max_dist = k                                   # Hamming distance in [0, K]
    n_bins = max_dist + 1
    if num_query == 0:
        z = np.zeros((0, n_bins), np.float32)
        return z, z.copy(), np.zeros((0,), np.float32)
    rc = _as_tensor(r_codes, dev, torch.int8)
    rl = _as_tensor(r_labels, dev, torch.float32)
    if chunk is None or chunk <= 0:
        chunk = max(64, min(2048, _chunk_budget_elems(dev) // max(rc.shape[0], 1)))
    qc = _as_tensor(q_codes, dev, torch.int8)
    ql = _as_tensor(q_labels, dev, torch.float32)
    parts = []
    for s in range(0, num_query, chunk):
        dist = (dist_fn or hamming_distance)(qc[s:s + chunk], rc)
        A, R = _bin_counts(dist, _gnd_matrix(ql[s:s + chunk], rl).float(), n_bins)
        parts.append((A, R, R.sum(1)))
    return tuple(torch.cat([p[i] for p in parts]).cpu().numpy() for i in range(3))


def _all_hists(q_codes, r_codes, q_labels, r_labels, chunk, dist_fn, max_dist, hists,
               device) -> Hists:
    if hists is not None:
        return hists
    return compute_hists(q_codes, r_codes, q_labels, r_labels, chunk, dist_fn, max_dist,
                         device)


def pr_curve(q_codes, r_codes, q_labels, r_labels, *, chunk: Optional[int] = None,
             dist_fn: Optional[DistFn] = None, max_dist: Optional[int] = None,
             hists: Optional[Hists] = None, device: Optional[DeviceLike] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(precision, recall) at radii 0..max_dist, float64 numpy: the mean over
    queries with a relevant item; a query that retrieves nothing within r
    counts precision 0 at r."""
    A, R, tsum = _all_hists(q_codes, r_codes, q_labels, r_labels, chunk, dist_fn,
                            max_dist, hists, device)
    valid = tsum > 0
    ret = np.cumsum(A, axis=1)                      # retrieved within <= r
    rel = np.cumsum(R, axis=1)                      # relevant within <= r
    prec_q = rel / np.maximum(ret, 1.0)
    rec_q = rel / np.maximum(tsum, 1.0)[:, None]
    n_valid = max(int(valid.sum()), 1)
    precision = (prec_q * valid[:, None]).sum(0) / n_valid
    recall = (rec_q * valid[:, None]).sum(0) / n_valid
    return precision, recall


def precision_at_n(q_codes, r_codes, q_labels, r_labels, ns: Sequence[int], *,
                   chunk: Optional[int] = None, dist_fn: Optional[DistFn] = None,
                   max_dist: Optional[int] = None, hists: Optional[Hists] = None,
                   device: Optional[DeviceLike] = None) -> np.ndarray:
    """Mean P@N for each N of ``ns`` (the expectation over tie orders);
    queries with no relevant item are skipped, as in :func:`pr_curve`."""
    A, R, tsum = _all_hists(q_codes, r_codes, q_labels, r_labels, chunk, dist_fn,
                            max_dist, hists, device)
    valid = tsum > 0
    L = np.cumsum(A, axis=1) - A                    # items strictly closer
    ns_arr = np.asarray(list(ns), np.float64)       # [M]
    incl = np.clip(ns_arr[:, None, None] - L[None], 0.0, A[None])    # [M, Q, bins]
    frac = np.divide(incl, A[None], out=np.zeros_like(incl), where=A[None] > 0)
    exp_rel = (frac * R[None]).sum(axis=2)          # [M, Q]
    n_valid = max(int(valid.sum()), 1)
    return (exp_rel * valid[None, :]).sum(axis=1) / (ns_arr * n_valid)


def default_topn(n_gallery: int) -> list:
    """12 log-spaced N up to the gallery size (``ccmh``'s default)."""
    return sorted({int(x) for x in np.logspace(0, np.log10(n_gallery), 12)})


def curves(q_codes, r_codes, q_labels, r_labels, ns: Sequence[int], **kw) -> dict:
    """Both curves from one histogram pass, as the ``curves-*.mat`` files
    hold them: radius, precision, recall, topn, p_at_n."""
    hists = compute_hists(q_codes, r_codes, q_labels, r_labels, **kw)
    precision, recall = pr_curve(q_codes, r_codes, q_labels, r_labels, hists=hists)
    p_at_n = precision_at_n(q_codes, r_codes, q_labels, r_labels, ns, hists=hists)
    return {"radius": np.arange(len(precision)), "precision": precision, "recall": recall,
            "topn": np.asarray(list(ns)), "p_at_n": p_at_n}


def main(argv=None) -> int:
    import argparse

    import scipy.io as scio

    ap = argparse.ArgumentParser(
        description="PR / topN-precision curves from a reference-layout PR_cruve .mat "
                    "code dump")
    ap.add_argument("mat", help="q_img/q_txt/r_img/r_txt/q_l/r_l layout "
                                "(train/base.py:328-349)")
    ap.add_argument("--direction", choices=["i2t", "t2i"], default="i2t")
    ap.add_argument("--topn", type=str, default="",
                    help="comma-separated N list for the P@N curve "
                         "(default: 12 log-spaced points up to the gallery)")
    ap.add_argument("-o", "--out", default="",
                    help="write curves to this .mat (default: print)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    mat = scio.loadmat(args.mat)
    qf, rf = ("q_img", "r_txt") if args.direction == "i2t" else ("q_txt", "r_img")
    qB, rB, qL, rL = mat[qf], mat[rf], mat["q_l"], mat["r_l"]
    ns = ([int(x) for x in args.topn.split(",")] if args.topn
          else default_topn(rB.shape[0]))
    out = curves(qB, rB, qL, rL, ns, device=args.device)
    if args.out:
        scio.savemat(args.out, out)
        print(f"wrote {args.out}")
    else:
        for r, (p, c) in enumerate(zip(out["precision"], out["recall"])):
            print(f"radius {r:3d}: P={p:.4f} R={c:.4f}")
        for n, p in zip(ns, out["p_at_n"]):
            print(f"P@{n}: {p:.4f}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
