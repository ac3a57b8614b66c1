"""Device-resident epochs: the decoded train split in the card's memory
(port of ``ccmh/data/resident.py`` for one device).

With a decoded-image cache (``data/cache.py``) the train split of a
reference-size dataset is small next to the card's memory (10,000 x 224 x
224 x 3 = 1.4 GiB), so it is copied to the card once
(:class:`ResidentImages`), and each step gathers its batch there by
``index_select`` from the batch's indices.  The host then sends only the
ids, labels, indices and valid flags, and all of an epoch's in one copy:
:func:`pack_epoch` packs each batch's fields into one uint8 row
(:class:`FusedBatchPut`) and stacks the rows into one table, and the
resident step (:func:`make_resident_epoch_step`) unpacks its row on the
card, gathers the images and runs the normal train step.  The cache makes
the pixels those of the streaming path, and the shuffle and the caption
draws stay functions of (seed, epoch, item), so training is bit for bit
the streaming run's: only the transport changes.

A split over the budget trains in the chunked mode: rows below R stay on
the card, the others stream once an epoch in superblock buffers of M rows,
copied on a side stream one superblock ahead (:func:`plan_chunked`,
:func:`augment_chunked_batches`, :func:`make_chunked_epoch_step`,
:class:`AsyncBlockPut`).  Eval splits pin whole (:class:`ResidentEvalSplit`)
and encode without a host copy per validation.

Departures from ``ccmh``: :class:`FusedBatchPut` aligns each field to 16
bytes in its buffer (``Tensor.view(dtype)`` needs aligned slices; a
layout change only); :meth:`ResidentEvalSplit.plan_bytes` counts the rows
and the token width that ``__init__`` pins; and :func:`plan_chunked`
streams where two minimum superblock buffers exceed the budget, where
``ccmh`` pins one row and commits the buffers anyway.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ALIGN = 16


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


class FusedBatchPut:
    """All of a batch's host fields in ONE uint8 buffer, copied from pinned
    memory at once (``data/prefetch.py`` to_device) and unpacked on the card by
    ``Tensor.view(dtype)`` slices: a pure layout transform, bit for bit
    the fields."""

    @staticmethod
    def pack(batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, tuple]:
        """(uint8 buffer, spec); spec = ((name, dtype, shape, offset), ...)
        in sorted name order, each field starting on a 16-byte boundary and
        the buffer a multiple of 16 bytes long."""
        spec, parts, off = [], [], 0
        for name, v in sorted(batch.items()):
            a = np.ascontiguousarray(v)
            raw = a.view(np.uint8).ravel()
            pad = (-off) % _ALIGN
            if pad:
                parts.append(np.zeros(pad, np.uint8))
                off += pad
            spec.append((name, a.dtype.str, a.shape, off))
            parts.append(raw)
            off += raw.size
        parts.append(np.zeros((-off) % _ALIGN, np.uint8))   # rows of a table stay aligned
        return np.concatenate(parts), tuple(spec)

    @staticmethod
    def unpack(buf: torch.Tensor, spec) -> Dict[str, torch.Tensor]:
        """uint8 buffer (on any device) -> the batch's tensors, views of it."""
        out = {}
        for name, dstr, shape, off in spec:
            dt = np.dtype(dstr)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            out[name] = buf[off:off + nbytes].view(_torch_dtype(dt)).reshape(shape)
        return out


def pack_epoch(batches) -> List[Tuple[np.ndarray, tuple, int]]:
    """[(table [n, L] uint8, spec, n)] for an epoch's host batches:
    consecutive batches of one spec stack into one table (every full
    batch), a ragged last batch forms its own; in epoch order."""
    groups = []
    cur_spec, cur = None, []
    for b in batches:
        buf, spec = FusedBatchPut.pack(b)
        if spec != cur_spec and cur:
            groups.append((np.stack(cur), cur_spec, len(cur)))
            cur = []
        cur_spec = spec
        cur.append(buf)
    if cur:
        groups.append((np.stack(cur), cur_spec, len(cur)))
    return groups


def make_resident_epoch_step(train_step: Callable) -> Callable:
    """``stepper(state, table, spec, row, epoch, images) -> (state,
    metrics)``: unpack row ``row`` of the epoch's table (on the card),
    gather its images from the resident split by ``index_select``, run
    ``train_step``.  No host copy per step."""
    def stepper(state, table: torch.Tensor, spec, row: int, epoch: torch.Tensor,
                images: torch.Tensor):
        b = FusedBatchPut.unpack(table[row], spec)
        b["image"] = images.index_select(0, b["index"].long())
        b["epoch"] = epoch
        return train_step(state, b)

    return stepper


def augment_chunked_batches(batches, n_resident: int, block_rows: int):
    """Annotate an epoch's (image-free) batches for the chunked mode.

    Rows ``< n_resident`` live in the pinned region; every other row
    streams once per epoch inside superblock buffers of ``block_rows``
    rows.  Batches go to superblocks greedily in epoch order (a superblock
    closes when the next batch's streamed rows would overflow it), so the
    batches are unchanged.  Adds ``is_res`` (bool), ``res_idx`` (the row
    in the region, 0 if streamed) and ``sb_pos`` (the row in its
    superblock's buffer, 0 if resident).  Returns ``(batches,
    superblocks, sb_of_batch)``: the dataset rows each superblock streams,
    in buffer order, and each batch's superblock."""
    superblocks, sb_of_batch = [], []
    cur: list = []
    augmented = []
    for b in batches:
        idx = np.asarray(b["index"], np.int64)
        is_res = idx < n_resident
        streamed = idx[~is_res]
        if len(streamed) > block_rows:
            raise ValueError(f"block_rows={block_rows} cannot hold one batch's "
                             f"{len(streamed)} streamed rows")
        if len(cur) + len(streamed) > block_rows and cur:
            superblocks.append(np.asarray(cur, np.int32))
            cur = []
        sb_pos = np.zeros(len(idx), np.int32)
        sb_pos[~is_res] = len(cur) + np.arange(len(streamed), dtype=np.int32)
        cur.extend(int(i) for i in streamed)
        b = dict(b)
        b["is_res"] = is_res
        b["res_idx"] = np.where(is_res, idx, 0).astype(np.int32)
        b["sb_pos"] = sb_pos
        augmented.append(b)
        sb_of_batch.append(len(superblocks))
    superblocks.append(np.asarray(cur, np.int32))   # the last, maybe empty
    return augmented, superblocks, sb_of_batch


def make_chunked_epoch_step(train_step: Callable) -> Callable:
    """``stepper(state, table, spec, row, epoch, region, sb_buf)``: as the
    resident stepper, with each image taken from the pinned region
    (``is_res``) or from the current superblock's buffer."""
    def stepper(state, table: torch.Tensor, spec, row: int, epoch: torch.Tensor,
                region: torch.Tensor, sb_buf: torch.Tensor):
        b = FusedBatchPut.unpack(table[row], spec)
        is_res = b.pop("is_res")
        res_idx = b.pop("res_idx").long()
        sb_pos = b.pop("sb_pos").long()
        b["image"] = torch.where(is_res[:, None, None, None],
                                 region.index_select(0, res_idx),
                                 sb_buf.index_select(0, sb_pos))
        b["epoch"] = epoch
        return train_step(state, b)

    return stepper


def plan_chunked(n: int, row_bytes: int, budget_bytes: int, batch_size: int,
                 block_rows: int = 0) -> Optional[Tuple[int, int]]:
    """(R pinned rows, M rows a superblock) for a split of ``n`` rows over
    the budget, or None where it should stream: the budget holds the
    region and two superblock buffers (the current one and the next),
    ``ccmh``'s sizing (``_init_chunked_residency``), except that two
    minimum buffers (``batch_size`` rows each) plus one region row over
    the budget stream instead of over-committing."""
    bs = max(batch_size, 1)
    if 2 * bs * row_bytes + row_bytes > budget_bytes:
        return None
    m = min(int(block_rows) or max(bs, 512), n)
    if budget_bytes <= 2 * m * row_bytes:
        m = bs
    r = int(min(n, max(1, (budget_bytes - 2 * m * row_bytes) // row_bytes)))
    # a barely-over-budget split streams few rows: cap the block at the
    # streamed remainder (>= one batch) and regrow the region
    m2 = max(bs, min(m, n - r))
    if m2 < m:
        m = m2
        r = int(min(n, max(1, (budget_bytes - 2 * m * row_bytes) // row_bytes)))
    return r, m


class AsyncBlockPut:
    """Superblock buffers copied one ahead: a thread gathers superblock
    g+1's rows from the cache into pinned memory and copies them on a side
    stream while superblock g's steps run; :meth:`get` makes the current
    stream wait for the copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._pending: Dict[int, Tuple[threading.Thread, dict]] = {}

    def start(self, key: int, fill: Callable[[], np.ndarray]) -> None:
        if key in self._pending:
            return
        slot: dict = {}

        def work():
            try:
                host = torch.from_numpy(fill())
                if self.side is None:
                    slot["buf"] = host.to(self.device)
                    return
                host = host.pin_memory()
                with torch.cuda.stream(self.side):
                    slot["buf"] = host.to(self.device, non_blocking=True)
                    slot["done"] = torch.cuda.Event()
                    slot["done"].record(self.side)
            except Exception as e:  # noqa: BLE001 - raised again by get()
                slot["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        self._pending[key] = (th, slot)

    def get(self, key: int) -> torch.Tensor:
        th, slot = self._pending.pop(key)
        th.join()
        if "err" in slot:
            raise slot["err"]
        buf = slot["buf"]
        if self.side is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(slot["done"])
            buf.record_stream(consumer)
        return buf


def _pin(arr: np.ndarray, device: torch.device, chunk_bytes: int = 64 << 20) -> torch.Tensor:
    """One host array (a memmap too) -> a tensor on ``device``, copied in
    pinned chunks."""
    out = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), device=device)
    row = max(1, int(np.prod(arr.shape[1:], dtype=np.int64)) * arr.dtype.itemsize)
    step = max(1, chunk_bytes // row)
    for s in range(0, len(arr), step):
        part = arr[s:s + step]
        # a read-only memmap (the cache) is copied: torch wants writable memory
        part = torch.from_numpy(np.array(part) if not part.flags.writeable
                                else np.ascontiguousarray(part))
        if device.type == "cuda":
            part = part.pin_memory()
        out[s:s + step].copy_(part, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


class ResidentImages:
    """The decoded uint8 images of one split on the card; ``gather(idx)``
    is an ``index_select`` there."""

    def __init__(self, images_u8: np.ndarray, device: torch.device):
        if images_u8.dtype != np.uint8 or images_u8.ndim != 4:
            raise ValueError(f"expected uint8 [N, R, R, 3] images, got "
                             f"{images_u8.dtype} {images_u8.shape}")
        self.n = len(images_u8)
        self.nbytes = int(images_u8.nbytes)
        self.images = _pin(images_u8, torch.device(device))

    def gather(self, idx) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long).to(self.images.device)
        return self.images.index_select(0, idx)

    @classmethod
    def plan(cls, cache, *, budget_mb: float, mode: str = "auto", logger=None) -> bool:
        """Whether ``cache`` goes resident: "off" never; "on" always
        (raises over the budget); "auto" where it fits ``budget_mb``."""
        if mode == "off" or cache is None:
            return False
        need = int(cache.images.nbytes)
        fits = need <= budget_mb * 2**20
        if mode == "on":
            if not fits:
                raise ValueError(f"device_resident_images=on but the split needs "
                                 f"{need / 2**20:.0f} MiB > budget {budget_mb:.0f} MiB")
            return True
        if not fits and logger is not None:
            logger.info(f"device-resident images: streaming ({need / 2**20:.0f} MiB > "
                        f"{budget_mb:.0f} MiB)")
        return fits

    @classmethod
    def maybe(cls, cache, *, budget_mb: float, device: torch.device, mode: str = "auto",
              logger=None) -> Optional["ResidentImages"]:
        """:meth:`plan`, then the pin."""
        if not cls.plan(cache, budget_mb=budget_mb, mode=mode, logger=logger):
            return None
        resident = cls(cache.images, device)
        if logger is not None:
            logger.info(f"device-resident images: pinned {resident.n} items "
                        f"({resident.nbytes / 2**20:.0f} MiB) to the card")
        return resident


def _eval_rows(n: int, batch_size: int) -> int:
    return -(-n // int(batch_size)) * int(batch_size)


class ResidentEvalSplit:
    """An eval split pinned whole: its uint8 images and its token ids,
    both padded with zero rows to whole batches.  Eval batches are the
    same every validation (no epoch in the caption draws, sequential
    order), so they pin once and every later ``valid`` encodes them with
    no host copy (:func:`make_resident_eval_encoder`)."""

    def __init__(self, cache, dataset, batch_size: int, device: torch.device):
        n = len(dataset)
        if len(cache.images) != n:
            raise ValueError(f"cache holds {len(cache.images)} items but the split has {n}")
        self.n = n
        self.batch = int(batch_size)
        n_pad = _eval_rows(n, batch_size)
        self.n_batches = n_pad // self.batch
        tokens = np.ascontiguousarray(dataset.meta_items(np.arange(n))["text"], np.int32)
        if tokens.shape[1] != dataset.max_words:
            raise ValueError(f"tokens are {tokens.shape[1]} wide, max_words is "
                             f"{dataset.max_words}")
        pad = n_pad - n
        images = cache.images
        if pad:
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], np.uint8)])
            tokens = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), np.int32)])
        device = torch.device(device)
        self.images = _pin(images, device)
        self.tokens = _pin(tokens, device)
        self.nbytes = int(self.images.nelement() * self.images.element_size()
                          + self.tokens.nelement() * self.tokens.element_size())

    @staticmethod
    def plan_bytes(cache, dataset, batch_size: int) -> int:
        """The bytes a pin takes, without pinning: the padded rows and the
        token width (``max_words``, what ``meta_items`` pads to) that
        ``__init__`` pins."""
        row = int(np.prod(cache.images.shape[1:], dtype=np.int64))
        return _eval_rows(len(cache.images), batch_size) * (row + 4 * int(dataset.max_words))


def make_resident_eval_encoder(encode_fn: Callable, split: ResidentEvalSplit) -> Callable:
    """``encode(params, aux)`` -> the split's codes, [n, K] int8 tensors on
    the card in the structure ``encode_fn`` returns (a pair, or TwDH's
    dict of pairs).  Each batch takes its rows of the pinned tables, with
    the fields the streaming ``get_code`` sends (image, text, valid);
    padded rows have ``valid`` False (the streaming loader wrap-pads
    instead; batch-statistics encodes mask both alike) and are dropped."""
    n, B = split.n, split.batch

    def to_int8(x):
        if isinstance(x, dict):
            return {k: to_int8(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(to_int8(v) for v in x)
        return x.to(torch.int8)

    def cat(parts: Sequence):
        first = parts[0]
        if isinstance(first, dict):
            return {k: cat([p[k] for p in parts]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(cat([p[i] for p in parts]) for i in range(len(first)))
        return torch.cat(parts)[:n]

    def encode(params, aux):
        outs = []
        dev = split.images.device
        with torch.inference_mode():
            for i in range(split.n_batches):
                idx = torch.arange(i * B, (i + 1) * B, device=dev)
                b = {"image": split.images[i * B:(i + 1) * B],
                     "text": split.tokens[i * B:(i + 1) * B], "valid": idx < n}
                outs.append(to_int8(encode_fn(params, aux, b)))
        return cat(outs)

    return encode
