"""Copy/compute overlap of the input path (port of ``ccmh/data/prefetch.py``).

:func:`device_prefetch` keeps ``ccmh``'s semantics: ``put`` runs up to
``depth`` batches ahead of the consumer, depth <= 1 is the serialized
control, and a ``StopIteration`` raised inside ``put`` propagates as an
error instead of ending the epoch early.

:class:`DevicePut` is the card's ``put``.  At depth >= 2 it copies each
array from pinned host memory on a side CUDA stream; the consumer's stream
waits on an event recorded after the copies, and every tensor is marked
with ``record_stream`` for the consumer's stream, so the caching allocator
never hands its memory out while the step still reads it.  Batch N+1's
copy then runs under step N's kernels.  At depth <= 1 it copies from
pageable memory on the current stream (synchronous): the serialized
control.  On the CPU it wraps the arrays without a copy.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def device_prefetch(
    batches: Iterable[Any],
    put: Callable[[Any], Any],
    depth: int = 2,
) -> Iterator[Any]:
    """Yield ``put(batch)`` for every batch, keeping up to ``depth``
    batches put ahead of the consumer (depth 2: a double buffer)."""
    if depth <= 1:
        for batch in batches:
            yield put(batch)
        return
    buf: deque = deque()
    it = iter(batches)
    exhausted = False
    while True:
        while not exhausted and len(buf) < depth:
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
            else:
                # put() runs outside the except: a StopIteration leaking out
                # of it must propagate, not pass for the end of the batches
                buf.append(put(item))
        if not buf:
            return
        yield buf.popleft()


def to_device(a, device: torch.device) -> torch.Tensor:
    """One array on ``device``: from pinned memory, asynchronously on the
    current stream (ordered before whatever reads it there)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class DevicePut:
    """``put`` for :func:`device_prefetch`: a dict of host arrays -> the
    same dict of tensors on ``device`` (see the module docstring)."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = torch.device(device)
        self.side: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda" and depth >= 2:
            self.side = torch.cuda.Stream(self.device)

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        host = {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: t.to(self.device) for k, t in host.items()}
        if self.side is None:
            return {k: t.to(self.device) for k, t in host.items()}
        host = {k: t if t.is_pinned() else t.pin_memory() for k, t in host.items()}
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.side):
            out = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self.side)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out
