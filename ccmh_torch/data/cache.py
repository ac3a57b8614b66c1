"""Decoded-image cache: decode once, stream every epoch (port of
``ccmh/data/cache.py``, the same on-disk layout and fingerprints, so a
cache that either package built is read by the other).

Both transforms are deterministic per item (resize + centre crop for
train, square resize for eval, dataset/base.py:35-44), so the decoded
image caches losslessly: one decode pass into a uint8 NHWC memmap, then
every epoch is a memmap gather.  Batches stay uint8 up to the card (4x
fewer bytes to copy than float32) and the tower normalizes them there
(``clip/model.py`` ``normalize_pixels``).

Layout of a cache directory:

    images.<fp12>.u8   raw C-order uint8 array, shape (N, R, R, 3); the
                       name carries the first 12 hex digits of the
                       dataset fingerprint
    meta.json          {"n", "resolution", "is_train", "fingerprint",
                       "data"}, written last, so its presence marks a
                       complete build; "data" names the payload file, so a
                       meta blesses only the pixels built for ITS
                       fingerprint (concurrent builders of divergent
                       datasets each land their own payload)

The payload is the loader's post-resize uint8 image: bit for bit what
streamed batches carry, and what ``ccmh``'s native loader writes.  An item
the loader cannot decode raises (``ccmh`` decodes it with PIL).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from ccmh_torch.data import native
from ccmh_torch.data.dataset import CrossModalDataset

_DATA = "images.u8"       # legacy (pre-v3) payload name, still readable
_META = "meta.json"


def _data_name(fingerprint: str) -> str:
    return f"images.{fingerprint[:12]}.u8"


def dataset_fingerprint(dataset: CrossModalDataset) -> str:
    """Identity of (sources, resolution, transform) — a cache built for a
    different split/resolution/transform must never be silently reused."""
    h = hashlib.sha256()
    h.update(f"v2|n={len(dataset)}|r={dataset.resolution}|"
             f"train={int(dataset.is_train)}|".encode())
    for i in range(len(dataset)):
        src = dataset.raw.indexes[i]
        if isinstance(src, np.ndarray) and src.ndim >= 2:
            # in-memory image: hash the pixels (bounded — sample large
            # arrays).  Items of an object-dtype container surface as
            # object-dtype views; normalize to a concrete dtype first.
            arr = np.ascontiguousarray(src)
            if arr.dtype == object:
                arr = arr.astype(np.float32)
            h.update(f"arr{arr.shape}{arr.dtype}".encode())
            flat = arr.view(np.uint8).ravel()
            h.update(flat[:: max(1, flat.size // 65536)].tobytes())
        else:
            path = dataset.image_path(i)
            if path is None:  # non-JPEG path source
                s = src.item() if isinstance(src, np.ndarray) else src
                path = str(s)
            h.update(path.encode())
            try:
                # an image edited IN PLACE (same filename) must invalidate
                # the cache: fold in size + mtime (one stat per item —
                # negligible next to the decode the cache exists to avoid)
                st = os.stat(path)
                h.update(f"|{st.st_size}|{st.st_mtime_ns}".encode())
            except OSError:
                pass  # missing file fails later at decode with a clear error
        h.update(b"|")
    return h.hexdigest()


class ImageCache:
    """Read view over a built cache directory."""

    def __init__(self, path: str):
        with open(os.path.join(path, _META)) as fh:
            self.meta = json.load(fh)
        self.path = path
        n, r = self.meta["n"], self.meta["resolution"]
        data = self.meta.get("data", _DATA)   # legacy metas name images.u8
        self.images = np.memmap(os.path.join(path, data), np.uint8,
                                mode="r", shape=(n, r, r, 3))

    def __len__(self) -> int:
        return int(self.meta["n"])

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """[B] indices -> [B, R, R, 3] uint8 (copies out of the memmap so
        batches own their memory once handed to the device)."""
        return np.ascontiguousarray(self.images[np.asarray(idx)])

    @staticmethod
    def build(
        dataset: CrossModalDataset,
        path: str,
        *,
        num_workers: int = 8,
        chunk: int = 512,
        force: bool = False,
        logger=None,
    ) -> "ImageCache":
        """Open ``path`` if it already holds a complete, fingerprint-matching
        cache for ``dataset``; otherwise decode every item into it.

        Decode uses the native C++ batch loader: JPEG paths in chunks of
        ``chunk`` (all cores, GIL-free), arrays item by item on
        ``num_workers`` threads.  The payload is
        written under a pid+uuid tmp name, renamed to its
        fingerprint-derived name only when complete, and meta.json (which
        references that exact payload file) is written after that — a
        crashed build can never be mistaken for a finished one, the old
        cache stays readable throughout a rebuild, and a meta can only
        bless the pixels built for ITS fingerprint even when concurrent
        builders point divergent datasets at one path (each lands its own
        payload; the losing builder's payload is garbage-collected by the
        next successful build).
        """
        fp = dataset_fingerprint(dataset)
        meta_path = os.path.join(path, _META)
        last_err: Optional[BaseException] = None
        for _attempt in range(3):
            if not force and os.path.exists(meta_path):
                try:
                    cache = ImageCache(path)
                    if cache.meta.get("fingerprint") == fp:
                        return cache
                except (OSError, ValueError, KeyError):
                    pass  # corrupt/partial — rebuild
            force = False  # a force rebuild happens once; retries may reuse
            ImageCache._build_once(dataset, path, fp, meta_path,
                                   num_workers=num_workers, chunk=chunk,
                                   logger=logger)
            # Validate the reopen against the fingerprint WE just built: a
            # concurrent divergent builder may have replaced meta.json (its
            # pixels, not ours) or garbage-collected our freshly-landed
            # payload — either way loop back into the build instead of
            # handing the caller someone else's pixels or an exception.
            try:
                cache = ImageCache(path)
                if cache.meta.get("fingerprint") == fp:
                    return cache
                last_err = ValueError(
                    f"concurrent builder won {path} with fingerprint "
                    f"{cache.meta.get('fingerprint')!r} != {fp!r}")
            except (OSError, ValueError, KeyError) as e:
                last_err = e
        raise RuntimeError(
            f"image cache build at {path} lost 3 consecutive races to "
            f"concurrent divergent builders") from last_err

    @staticmethod
    def _build_once(dataset, path, fp, meta_path, *, num_workers, chunk,
                    logger) -> None:
        """One decode pass + atomic payload/meta landing (no validation)."""
        from concurrent.futures import ThreadPoolExecutor

        os.makedirs(path, exist_ok=True)

        n, r = len(dataset), dataset.resolution
        # pid alone is NOT unique across hosts sharing a cache dir (NFS
        # multi-host runs); a uuid keeps concurrent builders from
        # interleaving writes into one tmp file
        import uuid

        token = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
        data_name = _data_name(fp)
        tmp = os.path.join(path, f"{data_name}.tmp.{token}")
        out = np.memmap(tmp, np.uint8, mode="w+", shape=(n, r, r, 3))
        try:
            import time as _time

            last_touch = _time.time()
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                for start in range(0, n, chunk):
                    idx = range(start, min(start + chunk, n))
                    paths = [dataset.image_path(i) for i in idx]
                    if all(p is not None for p in paths):
                        _, ok = native.decode_batch_u8(
                            paths, r, dataset.is_train, out=out[start:start + len(paths)])
                        if not ok.all():
                            j = int(np.flatnonzero(~ok)[0])
                            raise ValueError(f"item {start + j}: the loader cannot decode "
                                             f"{paths[j]}")
                    else:
                        for i, img in zip(idx, pool.map(dataset.load_image_u8, idx)):
                            out[i] = img
                    if logger is not None and start % (chunk * 16) == 0:
                        logger.info(f"image cache {path}: {start}/{n}")
                    # mmap-dirtied pages refresh mtime only on writeback, so a
                    # long build could look stale to a concurrent winner's tmp
                    # GC below; a periodic touch keeps the heuristic honest
                    if _time.time() - last_touch > 600:
                        os.utime(tmp)
                        last_touch = _time.time()
            out.flush()
            del out
            # the payload lands under its fingerprint-derived name; the old
            # meta (if any) keeps referencing the OLD payload until the new
            # meta atomically replaces it, so there is no window in which a
            # fingerprint blesses pixels it was not built from
            os.replace(tmp, os.path.join(path, data_name))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with open(meta_path + f".tmp.{token}", "w") as fh:
            json.dump({"n": n, "resolution": r,
                       "is_train": bool(dataset.is_train),
                       "fingerprint": fp, "data": data_name}, fh)
        os.replace(meta_path + f".tmp.{token}", meta_path)
        # garbage-collect superseded payloads (legacy images.u8, previous
        # fingerprints).  In-flight ".tmp." files are skipped — they belong
        # to live concurrent builders (which write continuously, keeping
        # their mtime fresh) — UNLESS they are older than a day: a builder
        # SIGKILLed mid-write never runs its `finally` unlink, and each
        # orphan is a full dataset-sized file.  A concurrent divergent
        # builder's completed payload may be collected here; its meta write
        # then yields a cache whose reopen fails validation and retries in
        # build() above — a visible retry, never wrong pixels.
        import time

        stale_tmp_s = 24 * 3600.0
        for name in os.listdir(path):
            full = os.path.join(path, name)
            if ".tmp." in name:
                try:
                    if time.time() - os.path.getmtime(full) > stale_tmp_s:
                        os.unlink(full)
                except OSError:
                    pass
                continue
            if (name != data_name and name != _META
                    and (name == _DATA or name.startswith("images."))):
                try:
                    os.unlink(full)
                except OSError:
                    pass


def open_or_build(
    dataset: CrossModalDataset, base_dir: str, split: str,
    *, num_workers: int = 8, logger=None,
) -> Optional[ImageCache]:
    """Cache for one split under ``base_dir`` with a self-describing name."""
    kind = "train" if dataset.is_train else "eval"
    path = os.path.join(base_dir, f"{split}_r{dataset.resolution}_{kind}")
    return ImageCache.build(dataset, path, num_workers=num_workers, logger=logger)
