"""Host-side dataset and batching (port of ``ccmh/data/dataset.py``).

Per-item semantics match ``ccmh`` (and the reference BaseDataset,
dataset/base.py:35-100):

* train transform: bicubic resize of the short side to R, centre crop;
  eval transform: bicubic resize to (R, R); both by the port's native
  loader (``data/native/``), a copy of ``ccmh``'s with PIL's resampling;
* CLIP pixel normalization (same constants, same op order);
* the caption is drawn among the item's captions by
  ``random.Random(mix)``, a pure function of (seed, epoch, item); BPE
  tokenized to SOT + tokens + EOT, zero-padded to ``max_words``;
* item -> (image, caption ids int32, label float32, index int32), and
  with ``with_mask`` the key-padding mask ``ids == 0`` (MITH's batches).

Images are JPEG paths (the reference's ``index.mat``, space-padded
strings) or npy-mode uint8 arrays of any size.  An item the loader cannot
decode (PNG, WebP, a corrupt file) raises ``ValueError`` naming the item
and its path: ``ccmh`` falls back to PIL there, and the port has no PIL.

:class:`BatchIterator` yields dicts of stacked numpy arrays from a
producer thread (``prefetch`` batches ahead).  A batch of JPEG paths is
decoded in one native call to uint8, and a batch read from a decoded-image
cache (``data/cache.py``) is uint8 too: the tower normalizes those on the
card (``clip/model.py`` ``normalize_pixels``), so every transport feeds it
the same bits.  npy-mode batches carry host-normalized float32, as in
``ccmh``.  The epoch's shuffle is a pure function of (seed, epoch).
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

from ccmh_torch.data import native
from ccmh_torch.data.split import RawData
from ccmh_torch.tokenizer.bpe import tokenize_batch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize_u8(arr: np.ndarray) -> np.ndarray:
    """uint8 -> CLIP-normalized float32 (``ccmh``'s op order, same bits)."""
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def images_from_bytes(blobs, resolution: int, is_train: bool = False) -> np.ndarray:
    """Raw JPEG files -> [N, R, R, 3] CLIP-normalized float32 (the serving
    path), in one native call.  Raises ``ValueError`` naming the first
    item the loader cannot decode."""
    blobs = list(blobs)
    images, ok = native.decode_batch_mem(blobs, resolution, is_train)
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise ValueError(f"image {i} is not a decodable JPEG ({len(blobs[i])} bytes)")
    return images


class CrossModalDataset:
    """Indexable dataset over one split."""

    def __init__(self, raw: RawData, *, is_train: bool = True, max_words: int = 32,
                 resolution: int = 224, seed: int = 0, with_mask: bool = False):
        self.raw = raw
        self.with_mask = with_mask
        self.is_train = is_train
        self.max_words = max_words
        self.resolution = resolution
        self.seed = seed
        self.epoch = 0          # set by BatchIterator.set_epoch

    def __len__(self) -> int:
        return len(self.raw.indexes)

    def all_labels(self) -> np.ndarray:
        return np.stack([np.asarray(l, np.float32).ravel() for l in self.raw.labels])

    def _caption(self, i: int) -> str:
        caps = self.raw.captions[i]
        if isinstance(caps, str):
            return caps
        caps = [c for c in np.ravel(np.asarray(caps, dtype=object))]
        if len(caps) > 1:
            mix = (int(self.seed) * 0x9E3779B1
                   + int(self.epoch) * 0x85EBCA77 + int(i)) & 0xFFFFFFFF
            choice = random.Random(mix).randrange(len(caps))
        else:
            choice = 0
        cap = caps[choice]
        if isinstance(cap, np.ndarray):
            cap = cap.item() if cap.size == 1 else str(cap)
        return str(cap)

    def image_path(self, i: int) -> Optional[str]:
        """Item i's JPEG path (``.strip()``-ed: ``index.mat`` strings are
        space-padded), or None for an in-memory array or another format."""
        src = self.raw.indexes[i]
        if isinstance(src, np.ndarray):
            if src.ndim >= 2:
                return None
            src = src.item() if src.size == 1 else src[0]
        if not isinstance(src, (str, bytes)):
            return None
        path = (src.decode() if isinstance(src, bytes) else str(src)).strip()
        return path if path.lower().endswith((".jpg", ".jpeg")) else None

    def load_image_u8(self, i: int) -> np.ndarray:
        """Item i after the resize and crop, before the normalization:
        [R, R, 3] uint8, the decoded-image cache's payload."""
        src = self.raw.indexes[i]
        r = self.resolution
        if isinstance(src, np.ndarray) and src.ndim >= 2:
            return native.resize_u8(src, r, self.is_train)
        path = self.image_path(i)
        if path is None:
            raise ValueError(f"item {i} ({src!r}) is not a JPEG path or a uint8 array; "
                             "ccmh_torch decodes JPEG files only")
        image, ok = native.decode_batch_u8([path], r, self.is_train, n_threads=1)
        if not ok[0]:
            raise ValueError(f"item {i}: the loader cannot decode {path}")
        return image[0]

    def load_image(self, i: int) -> np.ndarray:
        """Item i CLIP-normalized, [R, R, 3] float32.  An npy-mode array at
        the configured resolution passes through unresized, as PIL's
        resize to the same size returns its pixels."""
        src = self.raw.indexes[i]
        r = self.resolution
        if (isinstance(src, np.ndarray) and src.dtype == np.uint8
                and src.shape == (r, r, 3)):
            return normalize_u8(src)
        return normalize_u8(self.load_image_u8(i))

    def meta_items(self, idxs) -> Dict[str, np.ndarray]:
        """Captions (tokenized), labels and indices of a batch, and the
        key-padding mask with ``with_mask``."""
        caps = [self._caption(int(i)) for i in idxs]
        labels = np.stack([np.asarray(self.raw.labels[int(i)], np.float32).ravel()
                           for i in idxs])
        ids = tokenize_batch(caps, self.max_words)
        batch = {"text": ids, "label": labels, "index": np.asarray(idxs, np.int32)}
        if self.with_mask:
            batch["key_padding_mask"] = ids == 0
        return batch


class BatchIterator:
    """Threaded, prefetching batch producer.

    The final partial batch is wrap-padded (leading items repeated) to the
    full batch size with a ``valid`` mask, or yielded at its true size with
    ``ragged_last=True`` (the reference's train semantics, the Trainer's
    single-device default).  ``drop_last`` drops it."""

    def __init__(self, dataset: CrossModalDataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2, drop_last: bool = False, ragged_last: bool = False,
                 image_cache=None, with_images: bool = True, rows: Optional[slice] = None):
        self.dataset = dataset
        # data/cache.py ImageCache: batches carry its uint8 images
        self.image_cache = image_cache
        # False: meta and valid only (device-resident epochs gather the
        # pixels on the card from the batch's indices)
        self.with_images = with_images
        # a mesh rank's rows of each batch (parallel/mesh.py): the towers'
        # inputs (images, token ids, key-padding mask) are assembled for
        # these rows only; labels, indices and ``valid`` stay whole
        self.rows = rows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.ragged_last = ragged_last
        self._epoch = 0
        self._start_step = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle (and the caption draws) to an epoch index."""
        self._epoch = epoch
        self.dataset.epoch = epoch

    def set_start_step(self, step: int) -> None:
        """Skip the first ``step`` batches of the next iteration only; the
        skipped batches are never assembled.  The epoch's order and caption
        draws are functions of (seed, epoch, item), so batch ``step`` on is
        the uninterrupted epoch's (a mid-epoch resume)."""
        self._start_step = step

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _assemble(self, idx_batch: np.ndarray, n_valid: int, pool) -> Dict[str, np.ndarray]:
        batch = self.dataset.meta_items(idx_batch)
        mine = idx_batch
        if self.rows is not None:
            mine = idx_batch[self.rows]
            for key in ("text", "key_padding_mask"):
                if key in batch:
                    batch[key] = batch[key][self.rows]
        if self.with_images:
            batch["image"] = (self.image_cache.gather(mine) if self.image_cache is not None
                              else self._images(mine, pool))
        valid = np.zeros(len(idx_batch), bool)
        valid[:n_valid] = True
        batch["valid"] = valid
        return batch

    def _images(self, idx_batch: np.ndarray, pool) -> np.ndarray:
        """A batch of JPEG paths in one native call (uint8), else item by
        item on the pool (float32)."""
        ds = self.dataset
        paths = [ds.image_path(int(i)) for i in idx_batch]
        if any(p is None for p in paths):
            return np.stack(list(pool.map(ds.load_image, idx_batch)))
        images, ok = native.decode_batch_u8(paths, ds.resolution, ds.is_train)
        if not ok.all():
            j = int(np.flatnonzero(~ok)[0])
            raise ValueError(f"item {int(idx_batch[j])}: the loader cannot decode {paths[j]}")
        return images

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState((self.seed * 1_000_003 + self._epoch) % (2**32))
            order = rng.permutation(n)
            self._epoch += 1        # plain iteration still varies per epoch
        else:
            order = np.arange(n)
        starts = list(range(0, n, self.batch_size))
        if self.drop_last and n % self.batch_size:
            starts = starts[:-1]
        skip, self._start_step = self._start_step, 0
        starts = starts[skip:]

        queue: Queue = Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer(pool):
            # a worker exception goes to the consumer: a dead producer must
            # never leave the main thread blocked on the queue
            try:
                for s in starts:
                    if stop.is_set():
                        return
                    chunk = order[s:s + self.batch_size]
                    n_valid = len(chunk)
                    if n_valid < self.batch_size and not self.ragged_last:
                        chunk = np.concatenate([chunk, order[:self.batch_size - n_valid]])
                    queue.put(self._assemble(chunk, n_valid, pool))
            except BaseException as e:  # noqa: BLE001
                queue.put(e)
            queue.put(sentinel)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            thread = threading.Thread(target=producer, args=(pool,), daemon=True)
            thread.start()
            try:
                while True:
                    batch = queue.get()
                    if batch is sentinel:
                        break
                    if isinstance(batch, BaseException):
                        raise batch
                    yield batch
            finally:
                # a consumer that stops early must not leave the producer
                # blocked on a full queue
                stop.set()
                while thread.is_alive():
                    while not queue.empty():
                        queue.get_nowait()
                    thread.join(timeout=0.05)
