"""Offline TwDH hash-center generator: any dataset/class count -> npz.

The reference ships TwDH's class-center assets as ~90 pre-computed torch
pickles for exactly three datasets (train/TwDH/center/{coco,nuswide,
mirflickr}/{long,short,trans}/...pkl, loaded at model/TwDH.py:113-138) and
provides no way to create them — TwDH simply cannot run on a new dataset
upstream.  This tool generates compatible assets for ANY class count:

* **long/K** ``[C, K]`` ±1 class centers.  The vendored reference centers
  have ALL pairwise Hamming distances exactly K/2 — the signature of a
  Hadamard construction — so we use Sylvester-Hadamard rows (and their
  negations for C > K), topping up with greedy max-min sampled rows when
  C > 2K or K is not a power of two (the CSQ recipe, Yuan et al.,
  CVPR'20).
* **short/k** ``[C, k]`` ±1 centers, same construction at the short
  length.
* **trans/K/k** ``[2K, 2k]`` pair-space transforms fitted by least
  squares so that the model's re-quantization path
  (``softmax_pair_quantize(long_pairs @ trans)``, model/TwDH.py:148-167)
  reproduces the short centers exactly on every class vertex.  With
  C < 2K the min-norm solution interpolates all C one-hot pair rows, so
  the argmax-pair agreement is 100% (the reference's own trans measures
  99.84% on coco long=512/short=16).

Output npz layout matches ccmh_torch/assets/twdh/*.npz (ccmh's); point
``--set twdh.center_path=<out.npz>`` at it to train TwDH on the new
dataset.

    python -m ccmh_torch.data.builders.twdh_centers --nclass 291 \
        --long-dims 128 --short-dims 16 32 64 --out iapr_centers.npz
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

import numpy as np


def hadamard(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix [n, n] (n a power of two)."""
    assert n > 0 and (n & (n - 1)) == 0, f"{n} is not a power of two"
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _greedy_fill(existing: np.ndarray, n_extra: int, dim: int,
                 rng: np.random.RandomState, n_cand: int = 256) -> np.ndarray:
    """Sample ±1 rows one at a time, each the max-min-Hamming-distance
    candidate against everything chosen so far."""
    rows = [c for c in existing]
    out = []
    for _ in range(n_extra):
        cand = rng.randint(0, 2, size=(n_cand, dim)).astype(np.float32) * 2 - 1
        if rows:
            base = np.stack(rows)
            # Hamming distance = (dim - dot) / 2
            dists = (dim - cand @ base.T) / 2
            best = int(np.argmax(dists.min(axis=1)))
        else:
            best = 0
        rows.append(cand[best])
        out.append(cand[best])
    return np.stack(out) if out else np.zeros((0, dim), np.float32)


def gen_centers(n_class: int, dim: int, seed: int = 0) -> np.ndarray:
    """[C, dim] ±1 class centers: Hadamard rows, then greedy max-min
    samples.  (Negated-Hadamard rows would double the pool at distance
    K/2, but antipodal center pairs make short codes derived from ANY
    linear trans structurally inconsistent — sign(-h@d) == -sign(h@d) up
    to the bias — so the overflow uses general-position samples instead.)"""
    rng = np.random.RandomState(seed)
    pool = np.zeros((0, dim), np.float32)
    if dim > 0 and (dim & (dim - 1)) == 0:
        pool = hadamard(dim)
    if n_class <= pool.shape[0]:
        return pool[:n_class].astype(np.float32)
    extra = _greedy_fill(pool, n_class - pool.shape[0], dim, rng)
    return np.concatenate([pool, extra]).astype(np.float32)


def pair_encode(centers: np.ndarray) -> np.ndarray:
    """±1 [C, K] -> one-hot softmax-pair layout [C, 2K]: bit b of item i
    sets column 2b (for -1) or 2b+1 (for +1) — the layout of
    hash_convert (train/TwDH/hash_train.py:84-101)."""
    c, k = centers.shape
    bit = (centers > 0).astype(np.int64)                     # 0 / 1
    out = np.zeros((c, 2 * k), np.float32)
    cols = 2 * np.arange(k)[None, :] + bit                   # [C, K]
    out[np.arange(c)[:, None], cols] = 1.0
    return out


def fit_trans(long_centers: np.ndarray, short_centers: np.ndarray,
              max_iter: int = 5000, init_diff: np.ndarray = None) -> np.ndarray:
    """[2K, 2k] least-squares pair-space transform with exact vertex
    reproduction: argmax-pair(pair(long) @ T) == short centers.

    For C < 2K the min-norm LSQ solution interpolates every class vertex
    already.  For C >= 2K (e.g. 291 classes at long=128) the system is
    overdetermined and plain LSQ misquantizes ~25% of bits, so the pair
    *differences* (the only thing argmax sees) get a batch-perceptron
    refinement toward margin 1, redistributed antisymmetrically into the
    pair columns — the pair means (what the BCE sees through the softmax)
    stay at their LSQ fit."""
    x = pair_encode(long_centers)                            # [C, 2K]
    y = pair_encode(short_centers)                           # [C, 2k]
    t, *_ = np.linalg.lstsq(x, y, rcond=None)
    t = t.astype(np.float64)

    s = short_centers.astype(np.float64)                     # ±1 [C, k]
    d = t[:, 1::2] - t[:, 0::2]                              # [2K, k]
    if init_diff is not None:
        d = init_diff.astype(np.float64)                     # known-feasible

    def n_viol(diff):
        return int(((x @ diff) * s <= 1e-9).sum())

    best_d, best_viol = d.copy(), n_viol(d)
    if best_viol:
        # Ho–Kashyap, vectorized over all k bits: alternate the LSQ
        # solution for an all-positive signed-margin target M with the
        # monotone inflation M += rho*(E + |E|).  Converges to a separating
        # difference whenever one exists ((D_b X)^+ = X^+ D_b for the ±1
        # diagonal D_b, so one pinv of X serves every bit).
        xp = np.linalg.pinv(x)
        m = np.maximum((x @ d) * s, 1.0)                     # [C, k]
        rho = 0.9
        for _ in range(max_iter):
            d = xp @ (s * m)
            e = (x @ d) * s - m
            v = n_viol(d)
            if v < best_viol:
                best_d, best_viol = d.copy(), v
            if v == 0:
                break
            m = m + rho * (e + np.abs(e))
    base = (t[:, 1::2] + t[:, 0::2]) / 2.0
    t[:, 1::2] = base + best_d / 2.0
    t[:, 0::2] = base - best_d / 2.0
    return t.astype(np.float32)


def argmax_pair_agreement(long_centers: np.ndarray, short_centers: np.ndarray,
                          trans: np.ndarray) -> float:
    """Fraction of (class, bit) entries where re-quantizing the long pair
    encoding through ``trans`` reproduces the short center sign."""
    y = pair_encode(long_centers) @ trans                    # [C, 2k]
    k = short_centers.shape[1]
    pred = np.sign(y.reshape(-1, k, 2)[:, :, 1] - y.reshape(-1, k, 2)[:, :, 0])
    return float((pred == short_centers).mean())


def derive_shorts(long_centers: np.ndarray, dim: int, seed: int,
                  n_cand: int = 200) -> np.ndarray:
    """[C, dim] ±1 short centers as sign(long @ P), best-of-N random
    projections by min (then mean) pairwise Hamming distance.

    Used when the class count exceeds what the smallest long length can
    linearly separate (the pair encoding spans only K+1 affine dims, so
    for C >~ 2K independently chosen shorts are NOT reachable by any
    trans): a projected short is reachable by construction."""
    rng = np.random.RandomState(seed)
    c, kl = long_centers.shape
    best, best_p, best_key = None, None, (-1.0, -1.0)
    for _ in range(n_cand):
        p = rng.randn(kl, dim)
        s = np.where(long_centers @ p > 0, 1.0, -1.0).astype(np.float32)
        d = (dim - s @ s.T) / 2
        np.fill_diagonal(d, np.inf)
        finite = d[np.isfinite(d)]
        key = (float(d.min()), float(finite.mean()))
        if key > best_key:
            best, best_p, best_key = s, p, key
    return best, best_p


def generate_assets(n_class: int, long_dims: Sequence[int],
                    short_dims: Sequence[int], seed: int = 0) -> Dict[str, np.ndarray]:
    """npz-ready dict: long/K, short/k, trans/K/k for every combination.

    Short centers are shared across long lengths (the reference layout),
    so the smallest long length is the binding constraint: if its fitted
    trans cannot reproduce independently generated shorts on every class
    vertex, the shorts are regenerated as projections of that smallest
    long code (reachable exactly) and everything refits."""
    longs = {kl: gen_centers(n_class, kl, seed=seed + kl) for kl in long_dims}
    kmin = min(long_dims)
    shorts = {k: gen_centers(n_class, k, seed=seed + 1000 + k) for k in short_dims}
    exact = all(
        argmax_pair_agreement(longs[kmin], shorts[ks],
                              fit_trans(longs[kmin], shorts[ks])) == 1.0
        for ks in short_dims)
    projections = {}
    if not exact:
        for k in short_dims:
            shorts[k], projections[k] = derive_shorts(
                longs[kmin], k, seed=seed + 2000 + k)
    out: Dict[str, np.ndarray] = {}
    for k, c in shorts.items():
        out[f"short/{k}"] = c
    for kl in long_dims:
        out[f"long/{kl}"] = longs[kl]
        for ks, short_c in shorts.items():
            init = None
            if kl == kmin and ks in projections:
                # sign(long @ P) == argmax-pair with the interleaved (-P, P)
                # pair difference — a known-feasible perceptron warm start
                p = projections[ks]
                init = np.empty((2 * kl, ks), np.float64)
                init[0::2] = -p
                init[1::2] = p
            out[f"trans/{kl}/{ks}"] = fit_trans(longs[kl], short_c,
                                                init_diff=init)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="generate TwDH class-center / trans assets for any dataset")
    parser.add_argument("--nclass", type=int, required=True)
    parser.add_argument("--long-dims", type=int, nargs="+",
                        default=[128, 256, 512, 1024, 2048])
    parser.add_argument("--short-dims", type=int, nargs="+",
                        default=[16, 32, 64])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True, help="output .npz path")
    args = parser.parse_args(argv)

    assets = generate_assets(args.nclass, args.long_dims, args.short_dims,
                             seed=args.seed)
    np.savez_compressed(args.out, **assets)
    for kl in args.long_dims:
        long_c = assets[f"long/{kl}"]
        d = (kl - long_c @ long_c.T) / 2
        np.fill_diagonal(d, np.inf)
        for ks in args.short_dims:
            agree = argmax_pair_agreement(long_c, assets[f"short/{ks}"],
                                          assets[f"trans/{kl}/{ks}"])
            print(f"long={kl}: min pairwise hamming {int(d.min())}/{kl}; "
                  f"trans->short/{ks} vertex agreement {agree:.4f}")
    print(f"wrote {args.out} ({len(assets)} arrays, nclass={args.nclass})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
