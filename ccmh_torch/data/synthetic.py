"""Synthetic datasets for tests and the card's smoke run (port of
``ccmh/data/synthetic.py``; the same seed writes the same arrays, so the
two packages train on identical data).

Two forms, and TwDH's centre assets (:func:`write_synthetic_twdh_assets`):
* in-memory RawData with npy-mode images (uint8 arrays);
* on-disk files in the reference layout (index.npy, or JPEG files and an
  index.mat of their paths; caption.mat["caption"], label.mat["category"],
  dataset/dataloader.py:40-53).  The JPEGs come from the port's own
  encoder (``data/native/``) at ``ccmh``'s settings (quality 92, 4:2:0).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as scio
import torch
import torch.nn.functional as F

from ccmh_torch.data import native
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


def photo_like_images(n: int, height: int, width: int, seed: int = 0,
                      device="cpu") -> torch.Tensor:
    """[n, height, width, 3] uint8 images of smooth seeded content (a
    bicubic colour field, mid-scale blotches, fine texture), which JPEG
    compresses about as a photo (~55 KB at 500x375, quality 92), unlike
    white noise.  Made on ``device`` from a generator seeded there."""
    g = torch.Generator(device=device).manual_seed(seed)

    def field(rows, cols, amp, mode):
        x = torch.rand(n, 3, rows, cols, generator=g, device=device) * 2 - 1
        return F.interpolate(x, size=(height, width), mode=mode, align_corners=False) * amp

    x = (127.5 + field(4, 5, 127.5, "bicubic") + field(height // 16 + 1, width // 16 + 1, 40,
                                                        "bilinear")
         + field(height // 3 + 1, width // 3 + 1, 24, "bilinear"))
    return x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def write_synthetic_mat_dataset(
    out_dir: str,
    n: int = 64,
    n_class: int = 8,
    resolution: int = 32,
    seed: int = 0,
    jpeg: bool = False,
    captions_per_item: int = 3,
) -> str:
    """Write index.npy (npy image mode) + caption.mat + label.mat.

    ``jpeg=True`` writes the images as ``images/<i>.jpg`` and an index.mat
    of their paths instead: the reference's dataset layout
    (dataset/dataloader.py:46-48), as ``ccmh``'s writer lays it out."""
    os.makedirs(out_dir, exist_ok=True)
    raw = synthetic_arrays(n, n_class, resolution, seed=seed,
                           captions_per_item=captions_per_item)
    if jpeg:
        write_jpeg_index(out_dir, raw.indexes)
    else:
        np.save(os.path.join(out_dir, "index.npy"), raw.indexes)
    _write_captions_labels(out_dir, raw)
    return out_dir


def write_photo_jpeg_dataset(out_dir: str, n: int, n_class: int, seed: int = 0,
                             sizes=((375, 500), (500, 375)), device="cpu") -> str:
    """A JPEG dataset in the reference layout whose images are
    :func:`photo_like_images` at ``sizes`` (height, width; item i takes
    ``sizes[i % len(sizes)]``: MIRFlickr's two orientations by default),
    made on ``device`` 256 at a time and encoded by the port's encoder at
    quality 92; three captions an item and the labels as
    :func:`synthetic_arrays` draws them."""
    os.makedirs(out_dir, exist_ok=True)
    raw = synthetic_arrays(n, n_class, 1, seed=seed)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    paths = [os.path.join(img_dir, f"{i:06d}.jpg") for i in range(n)]
    for k, (h, w) in enumerate(sizes):
        items = list(range(k, n, len(sizes)))
        for s in range(0, len(items), 256):
            part = items[s:s + 256]
            imgs = photo_like_images(len(part), h, w, seed=seed * 1000 + k * 100003 + s,
                                     device=device).cpu().numpy()
            for i, blob in zip(part, native.encode_jpeg(list(imgs))):
                with open(paths[i], "wb") as fh:
                    fh.write(blob)
    scio.savemat(os.path.join(out_dir, "index.mat"), {"index": paths})
    _write_captions_labels(out_dir, raw)
    return out_dir


def _write_captions_labels(out_dir: str, raw: RawData) -> None:
    n = len(raw.labels)
    caption_cells = np.empty((1, n), dtype=object)
    for i in range(n):
        # plain '<U' char matrix per cell (NOT dtype=object): loadmat then
        # yields np.str_ elements, the layout the reference builders produce
        # (make_coco.py captionList) and its tokenizer consumes
        caption_cells[0, i] = np.asarray(raw.captions[i])
    scio.savemat(os.path.join(out_dir, "caption.mat"), {"caption": caption_cells})
    scio.savemat(os.path.join(out_dir, "label.mat"), {"category": raw.labels})


def write_jpeg_index(out_dir: str, images) -> list:
    """Encode ``images`` (uint8 [H, W, 3] each) as ``out_dir/images/
    <i:06d>.jpg`` and write ``out_dir/index.mat`` of their paths; returns
    the paths."""
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    paths = [os.path.join(img_dir, f"{i:06d}.jpg") for i in range(len(images))]
    for s in range(0, len(paths), 256):
        for p, blob in zip(paths[s:s + 256], native.encode_jpeg(images[s:s + 256])):
            with open(p, "wb") as fh:
                fh.write(blob)
    # a plain list of strings: scipy stores a space-padded [N] char matrix,
    # the reference builder's layout (make_coco.py:159-163), hence the
    # .strip() of its BaseDataset (dataset/base.py:55)
    scio.savemat(os.path.join(out_dir, "index.mat"), {"index": paths})
    return paths


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
