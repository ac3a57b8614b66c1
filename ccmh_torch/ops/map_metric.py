"""mAP over a Hamming ranking on the device (port of ``ccmh/ops/map_metric.py``).

The reference ranks with a CPU Python loop over queries
(utils/calc_utils.py:16-39).  Here each query chunk is a few tensor passes:

  1. Hamming distances from the ±1 codes by one matmul (``hamming_distance``:
     an fp16 GEMM on the card, exact for K <= 2048)               [C, N]
  2. relevance: one label matmul > 0                                [C, N]
  3. ``exact``: one stable sort of each row by distance, ties in gallery
     index order (the distance, index and relevance packed into ONE int32
     key when they fit, as ``ccmh`` does), then AP from the cumulative sum
     of the sorted relevance:
       AP_q = (1/total) sum_s rel[s] (csum[s] <= total) csum[s] / (s+1),
     total = min(k, tsum); queries with tsum == 0 count as 0 in the mean;
     ``hist``: the sort-free expected AP over random tie orders from
     per-distance histograms (McSherry & Najork, ECIR'08), mAP@all only.

``dist_fn`` replaces step 1 with a method's own integer distances in
[0, n_bins) (DPSIH's multi-embed ranking); the exact path then sorts
(distance, relevance) pairs stably instead of the packed key, as ``ccmh``
does.  Queries run in chunks so the [chunk, N] working set stays bounded.
Over a mesh (``mesh=``) the queries, or with ``shard_gallery`` the gallery,
split over the data ranks.  Bit-packed labels are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ccmh_torch.device import DeviceLike, resolve_device
from ccmh_torch.ops.hamming import hamming_distance


# (distance, gallery index, relevance) pack into one int32 sort key when
# they fit in this many bits; otherwise a two-operand stable sort
_KEY_BITS = 31


def _gnd_matrix(q_labels: torch.Tensor, r_labels: torch.Tensor) -> torch.Tensor:
    """Relevance [C, N] int32: "any shared label"."""
    return ((q_labels @ r_labels.T) > 0).to(torch.int32)


def _chunk_budget_elems(device: torch.device) -> int:
    """Element budget of the [chunk, N] working set: ~12 bytes an element
    live through the sort, half the card's memory, at least 2^28."""
    if device.type != "cuda":
        return 1 << 28
    total = torch.cuda.get_device_properties(device).total_memory
    return max(1 << 28, int(total * 0.5) // 12)


DistFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _map_chunk(q_codes, r_codes, q_labels, r_labels, k: Optional[int],
               dist_fn: Optional[DistFn] = None) -> torch.Tensor:
    """Sum of the chunk's per-query APs (float32 scalar), stable ranking."""
    n = r_codes.shape[0]
    dist = (dist_fn or hamming_distance)(q_codes, r_codes)        # [C, N] int32
    gnd = _gnd_matrix(q_labels, r_labels)
    tsum = gnd.sum(1)
    total = tsum if k is None else torch.clamp(tsum, max=k)
    dist_bits = (q_codes.shape[1] + 1).bit_length()                # distance in [0, K]
    idx_bits = max(n - 1, 1).bit_length()
    if dist_fn is None and dist_bits + idx_bits + 1 <= _KEY_BITS:
        idx = torch.arange(n, dtype=torch.int32, device=dist.device)[None, :]
        packed = (dist << (idx_bits + 1)) | (idx << 1) | gnd
        gnd_sorted = torch.sort(packed, dim=1).values & 1
    else:
        order = torch.sort(dist, dim=1, stable=True).indices
        gnd_sorted = torch.gather(gnd, 1, order)
    csum = torch.cumsum(gnd_sorted, dim=1)
    positions = torch.arange(1, n + 1, dtype=torch.float32, device=dist.device)
    contrib = gnd_sorted * (csum <= total[:, None])
    precision = csum.float() / positions
    ap_sum = (contrib * precision).sum(1)
    ap = torch.where(total > 0, ap_sum / torch.clamp(total, min=1).float(),
                     torch.zeros((), device=dist.device))
    return ap.sum()


def _bin_counts(dist: torch.Tensor, gnd: torch.Tensor, n_bins: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, R) [C, n_bins] float32: items, and relevant items, at each distance."""
    C = dist.shape[0]
    A = torch.zeros((C, n_bins), dtype=torch.float32, device=dist.device)
    R = torch.zeros_like(A)
    index = dist.long()
    A.scatter_add_(1, index, torch.ones_like(gnd))
    R.scatter_add_(1, index, gnd)
    return A, R


def _hist_counts(q_codes, r_codes, q_labels, r_labels, n_bins: int,
                 dist_fn: Optional[DistFn] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk's per-distance counts (A, R) over the gallery rows given."""
    dist = (dist_fn or hamming_distance)(q_codes, r_codes)
    gnd = _gnd_matrix(q_labels, r_labels).float()
    return _bin_counts(dist, gnd, n_bins)


def _hist_ap_sum(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Sum of the chunk's expected APs over random tie orders.  With A_d
    items (R_d relevant) at distance d, L_d / P_d of them (relevant) closer,
    and H the harmonic number (via digamma), group d contributes
        (R_d/A_d) [ (P_d+1) S1 + (R_d-1)/(A_d-1) (A_d - (L_d+1) S1) ],
        S1 = H(L_d+A_d) - H(L_d)."""
    L = torch.cumsum(A, dim=1) - A
    P = torch.cumsum(R, dim=1) - R

    def harm(x):                                                   # H(x) - gamma
        return torch.special.digamma(x + 1.0)

    S1 = harm(L + A) - harm(L)
    safe_A1 = torch.clamp(A - 1.0, min=1.0)
    contrib = (R / torch.clamp(A, min=1.0)) * (
        (P + 1.0) * S1 + (R - 1.0) / safe_A1 * (A - (L + 1.0) * S1))
    zero = torch.zeros((), device=A.device)
    contrib = torch.where(A > 0, contrib, zero)
    tsum = R.sum(1)
    ap = torch.where(tsum > 0, contrib.sum(1) / torch.clamp(tsum, min=1.0), zero)
    return ap.sum()


def _as_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


def _map_chunk_hist(q_codes, r_codes, q_labels, r_labels, n_bins: int,
                    dist_fn: Optional[DistFn] = None) -> torch.Tensor:
    return _hist_ap_sum(*_hist_counts(q_codes, r_codes, q_labels, r_labels, n_bins, dist_fn))


def _share(n: int, mesh) -> slice:
    """The data rank's contiguous share of ``n`` rows (the last may be short)."""
    per = -(-n // mesh.dp)
    return slice(min(mesh.data_rank * per, n), min((mesh.data_rank + 1) * per, n))


def calc_map(q_codes, r_codes, q_labels, r_labels, k: Optional[int] = None,
             chunk: Optional[int] = None, method: str = "auto",
             n_bins: Optional[int] = None,
             device: Optional[DeviceLike] = None,
             dist_fn: Optional[DistFn] = None, mesh=None,
             shard_gallery: Optional[bool] = None) -> torch.Tensor:
    """mAP@k of the Hamming ranking (k=None: mAP@all), a float32 scalar on
    the device; the mean is over ALL queries, zero-relevance ones included
    (reference parity).  ``dist_fn(q, r) -> int32 [Q, N]`` replaces the
    Hamming distance (its values must lie in [0, n_bins) for "hist").

    ``method``: "exact" — stable sort, ties in gallery index order;
    "hist" — the sort-free expected-tie AP (mAP@all only); "auto" — hist
    when k is None, exact otherwise.  ``chunk``: queries per pass (default:
    as many as keep the [chunk, N] working set in budget).  Inputs may be
    tensors or numpy arrays; ``device`` defaults to the codes' device for a
    tensor, else cuda.

    ``mesh`` (``parallel/mesh.py``; every rank calls with the same inputs):
    each data rank ranks its share of the queries against the whole
    gallery, and the AP sums are summed over the data axis.
    ``shard_gallery``: each rank holds its share of the gallery instead and
    ranks every query against it; the per-distance counts are summed over
    the data axis before the AP (hist path only: the exact path's full-row
    sort would need the whole distance row).  Default (None): on for
    hist-path galleries of >= 2^20 items over more than one data rank.
    Either way every rank returns the same number."""
    use_hist = method == "hist" or (method == "auto" and k is None)
    if method not in ("exact", "hist", "auto"):
        raise ValueError(f"method must be 'exact', 'hist' or 'auto', got {method!r}")
    if use_hist and k is not None:
        raise ValueError("the hist method computes mAP@all only (k=None)")
    ndev = mesh.dp if mesh is not None else 1
    num_gallery = int(r_codes.shape[0])
    if shard_gallery is None:
        shard_gallery = mesh is not None and use_hist and ndev > 1 and num_gallery >= 1 << 20
    if shard_gallery:
        if mesh is None:
            raise ValueError("shard_gallery requires a mesh")
        if not use_hist:
            raise ValueError(
                "shard_gallery supports the hist path only: the exact "
                "path's full-row stable sort would all-gather the sharded "
                "distance matrix (use the default query sharding for exact)")
    if device is None:
        device = q_codes.device if isinstance(q_codes, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    qc = _as_tensor(q_codes, dev, torch.int8)
    rc = _as_tensor(r_codes, dev, torch.int8)
    ql = _as_tensor(q_labels, dev, torch.float32)
    rl = _as_tensor(r_labels, dev, torch.float32)
    num_query = qc.shape[0]
    if n_bins is None:
        n_bins = qc.shape[1] + 1
    if mesh is not None:
        if shard_gallery:
            rows = _share(num_gallery, mesh)
            rc, rl = rc[rows], rl[rows]
        else:
            rows = _share(num_query, mesh)
            qc, ql = qc[rows], ql[rows]
    if chunk is None:
        chunk = max(256, min(num_query, _chunk_budget_elems(dev) // max(rc.shape[0], 1)))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for start in range(0, qc.shape[0], chunk):
        q, l = qc[start:start + chunk], ql[start:start + chunk]
        if shard_gallery:
            counts = torch.stack(_hist_counts(q, rc, l, rl, n_bins, dist_fn))
            dist.all_reduce(counts, group=mesh.data_group)
            total = total + _hist_ap_sum(counts[0], counts[1])
        elif use_hist:
            total = total + _map_chunk_hist(q, rc, l, rl, n_bins, dist_fn)
        else:
            total = total + _map_chunk(q, rc, l, rl, k, dist_fn)
    if mesh is not None and not shard_gallery:
        dist.all_reduce(total, group=mesh.data_group)
    return total / num_query


def calc_map_4way(query_img, query_txt, retrieval_img, retrieval_txt, q_labels, r_labels,
                  k: Optional[int] = None, chunk: Optional[int] = None,
                  method: str = "auto", n_bins: Optional[int] = None,
                  device: Optional[DeviceLike] = None, dist_fn: Optional[DistFn] = None,
                  mesh=None, shard_gallery: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i2t, t2i, i2i, t2t) mAP, the reference's validation quartet
    (train/base.py:259-262); the labels move to the device once.  ``mesh``
    and ``shard_gallery`` as in :func:`calc_map`."""
    if device is None:
        device = query_img.device if isinstance(query_img, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    ql = _as_tensor(q_labels, dev, torch.float32)
    rl = _as_tensor(r_labels, dev, torch.float32)
    kw = dict(k=k, chunk=chunk, method=method, n_bins=n_bins, device=dev, dist_fn=dist_fn,
              mesh=mesh, shard_gallery=shard_gallery)
    i2t = calc_map(query_img, retrieval_txt, ql, rl, **kw)
    t2i = calc_map(query_txt, retrieval_img, ql, rl, **kw)
    i2i = calc_map(query_img, retrieval_img, ql, rl, **kw)
    t2t = calc_map(query_txt, retrieval_txt, ql, rl, **kw)
    return i2t, t2i, i2i, t2t
