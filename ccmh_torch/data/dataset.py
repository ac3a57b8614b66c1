"""Host-side dataset and batching (port of ``ccmh/data/dataset.py``).

Per-item semantics match ``ccmh`` (and the reference BaseDataset,
dataset/base.py:35-100):

* the caption is drawn among the item's captions by
  ``random.Random(mix)``, a pure function of (seed, epoch, item); BPE
  tokenized to SOT + tokens + EOT, zero-padded to ``max_words``;
* images are CLIP-normalized NHWC float32 (same constants, same op order,
  so the same bits as ``ccmh``'s ``normalize_u8``);
* item -> (image, caption ids int32, label float32, index int32), and
  with ``with_mask`` the key-padding mask ``ids == 0`` (MITH's batches).

Images: npy-mode arrays only.  An image already at the configured
resolution passes through unchanged, which is exactly what ``ccmh`` yields
for it: PIL's bicubic resize to the same size returns the pixels as they
are, and so does the centre crop.  Other sizes and JPEG paths need a
decoder and a resize without Pillow and raise "not yet ported".  There is
no image cache and no device residency.

:class:`BatchIterator` yields dicts of stacked numpy arrays from a
producer thread (``prefetch`` batches ahead, items assembled by a thread
pool), so host assembly overlaps the card's step.  The epoch's shuffle is
a pure function of (seed, epoch).
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Dict, Iterator

import numpy as np

from ccmh_torch.data.split import RawData
from ccmh_torch.tokenizer.bpe import tokenize_batch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize_u8(arr: np.ndarray) -> np.ndarray:
    """uint8 -> CLIP-normalized float32 (``ccmh``'s op order, same bits)."""
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


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

    def load_image(self, i: int) -> np.ndarray:
        src = self.raw.indexes[i]
        r = self.resolution
        if not (isinstance(src, np.ndarray) and src.dtype == np.uint8
                and src.shape == (r, r, 3)):
            what = (f"a {src.dtype} array of shape {src.shape}"
                    if isinstance(src, np.ndarray) else f"{type(src).__name__} {src!r}")
            raise NotImplementedError(
                f"item {i} is {what}: ccmh_torch takes npy-mode uint8 images at "
                f"the configured resolution ({r}, {r}, 3) only; decoding and "
                "resizing images (JPEG paths, other sizes) is not yet ported")
        return normalize_u8(src)

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
                 prefetch: int = 2, drop_last: bool = False, ragged_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.ragged_last = ragged_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle (and the caption draws) to an epoch index."""
        self._epoch = epoch
        self.dataset.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _assemble(self, idx_batch: np.ndarray, n_valid: int, pool) -> Dict[str, np.ndarray]:
        batch = self.dataset.meta_items(idx_batch)
        batch["image"] = np.stack(list(pool.map(self.dataset.load_image, idx_batch)))
        valid = np.zeros(len(idx_batch), bool)
        valid[:n_valid] = True
        batch["valid"] = valid
        return batch

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
