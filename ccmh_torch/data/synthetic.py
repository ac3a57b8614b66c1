"""Synthetic datasets for tests and the card's smoke run (port of
``ccmh/data/synthetic.py``; the same seed writes the same arrays, so the
two packages train on identical data).

Two forms, and TwDH's centre assets (:func:`write_synthetic_twdh_assets`):
* in-memory RawData with npy-mode images (uint8 arrays);
* on-disk files in the reference layout (index.npy, caption.mat["caption"],
  label.mat["category"], dataset/dataloader.py:40-53).

The JPEG form of ``ccmh`` needs Pillow, which the port does not use; it
raises "not yet ported".
"""

from __future__ import annotations

import os
import numpy as np
import scipy.io as scio

from ccmh_torch.data.split import RawData

_WORDS = (
    "a the of on in cat dog man woman tree car road sky sea boat bird "
    "red green blue small large photo picture group person riding standing "
    "playing holding table room street mountain snow water grass field"
).split()


def synthetic_arrays(
    n: int = 64,
    n_class: int = 8,
    resolution: int = 32,
    captions_per_item: int = 3,
    seed: int = 0,
) -> RawData:
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, size=(n, resolution, resolution, 3), dtype=np.uint8)
    captions = np.empty(n, dtype=object)
    for i in range(n):
        captions[i] = [
            " ".join(rng.choice(_WORDS, size=rng.randint(3, 10)))
            for _ in range(captions_per_item)
        ]
    labels = (rng.rand(n, n_class) < 0.25).astype(np.float32)
    labels[np.arange(n), rng.randint(0, n_class, n)] = 1.0  # no empty labels
    return RawData(captions, images, labels)


def write_synthetic_mat_dataset(
    out_dir: str,
    n: int = 64,
    n_class: int = 8,
    resolution: int = 32,
    seed: int = 0,
    jpeg: bool = False,
    captions_per_item: int = 3,
) -> str:
    """Write index.npy (npy image mode) + caption.mat + label.mat."""
    if jpeg:
        raise NotImplementedError(
            "jpeg=True (JPEG files and an index.mat of paths) is not yet "
            "ported to ccmh_torch: it needs an image encoder and decoder")
    os.makedirs(out_dir, exist_ok=True)
    raw = synthetic_arrays(n, n_class, resolution, seed=seed,
                           captions_per_item=captions_per_item)
    np.save(os.path.join(out_dir, "index.npy"), raw.indexes)
    caption_cells = np.empty((1, n), dtype=object)
    for i in range(n):
        # plain '<U' char matrix per cell (NOT dtype=object): loadmat then
        # yields np.str_ elements, the layout the reference builders produce
        # (make_coco.py captionList) and its tokenizer consumes
        caption_cells[0, i] = np.asarray(raw.captions[i])
    scio.savemat(os.path.join(out_dir, "caption.mat"), {"caption": caption_cells})
    scio.savemat(os.path.join(out_dir, "label.mat"), {"category": raw.labels})
    return out_dir


def write_synthetic_twdh_assets(path: str, n_class: int = 8, long_bits: int = 16,
                                short_bits: int = 8, seed: int = 0) -> str:
    """A synthetic TwDH centre/transform ``.npz`` (one long length, one
    short length; the layout ``losses.twdh.load_twdh_assets`` reads), for
    tiny runs that no shipped asset fits.  With ``long_bits = 2 *
    short_bits`` it writes the arrays ``ccmh``'s writer does."""
    if not os.path.exists(path):
        r = np.random.RandomState(seed)
        np.savez(path, **{
            f"long/{long_bits}":
                (r.randint(0, 2, (n_class, long_bits)) * 2 - 1).astype(np.float32),
            f"short/{short_bits}":
                (r.randint(0, 2, (n_class, short_bits)) * 2 - 1).astype(np.float32),
            f"trans/{long_bits}/{short_bits}":
                r.randn(2 * long_bits, 2 * short_bits).astype(np.float32),
        })
    return path
