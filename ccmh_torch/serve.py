"""HTTP serving daemon for cross-modal hash retrieval (port of
``ccmh/serve.py``).

A thread-per-request JSON HTTP service (stdlib ``http.server``) over the
device-resident serving stack (:class:`ccmh_torch.retrieval.Retriever` +
:class:`ccmh_torch.retrieval.HashIndex`) on an NVIDIA card.

Endpoints (all JSON):

* ``GET  /healthz`` — liveness + model/gallery metadata.
* ``POST /v1/encode`` — ``{"texts": [...]}`` or ``{"images": [[...]]}``
  (nested lists, CLIP-normalized NHWC) or ``{"images_b64": "<base64 .npy>"}``
  → ``{"codes": [[±1, ...]]}``.  ``{"images_jpeg_b64": [...]}``: raw JPEG
  files, decoded server-side by the native loader (eval transform); bad
  base64 or an undecodable file answers 400.
* ``POST /v1/search`` — an encode body plus ``{"k": 10, "index": "image"}``
  → ``{"indices": [[...]], "distances": [[...]]}`` (exact Hamming top-k,
  the stable tie order of the exact eval path).
* ``POST /v1/add`` — ``{"index": "image", "codes": [[...]]}`` or an encode
  body → appends to the gallery via the streaming ``HashIndex.add``
  (on-device slice update, no rebuild/recompile) → new gallery size.

Device work is serialized with a lock: one encode/search at a time keeps
per-request latency predictable on a single card; the HTTP layer stays
threaded so slow clients don't block encode-ready ones.

Concurrent requests are **dynamically micro-batched** (:class:`_Batcher`):
same-kind requests (text encode / image encode / search on the same
(index, k)) that arrive while the device is busy coalesce into ONE device
call.  The default window is zero — a lone request never waits for future
arrivals — so batching is latency-neutral and kicks in exactly when the
service is loaded (requests pile up behind the in-flight device call and
drain together).  Coalesced batches are padded to power-of-two row
buckets, as in ``ccmh`` (where the buckets bound the set of compiled
executables), so both packages see the same device batch shapes.
``/healthz`` reports per-batcher ``{requests, batches, rows}``
so the coalescing is observable.

Start: ``python -m ccmh_torch.serve --method DCHMT --pretrained ckpt.npz
--gallery index.npz --port 8080`` (see ``--help``; ``--pretrained`` is an
``.npz`` checkpoint in the ``ccmh`` Trainer format, ``--gallery`` a
``HashIndex.save`` file of either package or a PR_cruve ``.mat``).
"""

from __future__ import annotations

import base64
import binascii
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ccmh_torch.data.dataset import images_from_bytes

__all__ = ["RetrievalService", "serve", "main"]


class ServiceError(ValueError):
    """Client error -> HTTP 400 with a JSON message."""


def _pad0(rows: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad rows to n (zeros are valid fillers for both modalities:
    a zero caption has no tokens, a zero image is a plain gray frame —
    padded outputs are sliced away before anyone sees them)."""
    if rows.shape[0] == n:
        return rows
    pad = np.zeros((n - rows.shape[0],) + rows.shape[1:], rows.dtype)
    return np.concatenate([rows, pad])


def _batch_size(body: Dict[str, Any]) -> int:
    """Client-supplied device batch size (no-batching mode); 400 on junk."""
    try:
        bs = int(body.get("batch_size", 256))
    except (ValueError, TypeError):
        raise ServiceError("'batch_size' must be an int")
    if bs < 1:
        raise ServiceError(f"'batch_size' must be >= 1 (got {bs})")
    return bs


def _bucket(n: int, cap: int = 256) -> int:
    """Row-count bucket: next power of two up to ``cap``, then multiples
    of ``cap``.  Bounds the compiled-executable set to {1,2,4,...,cap}
    (plus the cap-wide chunk loop) no matter what sizes clients send."""
    if n >= cap:
        return -(-n // cap) * cap
    return 1 << max(0, n - 1).bit_length()


class _Item:
    __slots__ = ("rows", "done", "result", "exc")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.done = threading.Event()
        self.result: Any = None
        self.exc: Optional[BaseException] = None


class _Batcher:
    """Coalesces concurrent same-kind requests into one device call.

    ``run`` takes the row-concatenated input of a whole group and returns
    an array (or tuple of arrays) with one output row per input row; the
    batcher splits it back per request.  ``window_ms=0`` (default) is
    zero added latency: a request only coalesces with what is ALREADY
    queued when the worker frees up — under load, arrivals pile up behind
    the in-flight device call and drain as one batch.  A positive window
    additionally holds the first request open for stragglers (useful for
    testing and for throughput-over-latency deployments).
    """

    def __init__(self, run: Callable[[np.ndarray], Any],
                 max_rows: int = 256, window_ms: float = 0.0):
        self._run = run
        self._max_rows = max_rows
        self._window = window_ms / 1e3
        self._cv = threading.Condition()
        self._pending: List[_Item] = []
        self._worker: Optional[threading.Thread] = None
        # observability (read by /healthz)
        self.requests = 0
        self.batches = 0
        self.rows = 0

    def submit(self, rows: np.ndarray) -> Any:
        item = _Item(rows)
        with self._cv:
            self._pending.append(item)
            self.requests += 1
            if self._worker is None:
                self._worker = threading.Thread(target=self._loop,
                                                daemon=True)
                self._worker.start()
            self._cv.notify()
        item.done.wait()
        if item.exc is not None:
            raise item.exc
        return item.result

    def _take_group(self) -> List[_Item]:
        """Called with the cv held: wait for work, optionally hold the
        window open, then pop a group capped at ``max_rows`` (a single
        oversized request still goes alone — ``run`` chunks internally)."""
        while not self._pending:
            self._cv.wait()
        if self._window > 0:
            deadline = time.monotonic() + self._window
            while (sum(i.rows.shape[0] for i in self._pending)
                   < self._max_rows):
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(left):
                    break
        group, total = [], 0
        while self._pending:
            nxt = self._pending[0].rows.shape[0]
            if group and total + nxt > self._max_rows:
                break
            group.append(self._pending.pop(0))
            total += nxt
        return group

    def _loop(self) -> None:
        while True:
            with self._cv:
                group = self._take_group()
            try:
                out = self._run(np.concatenate([i.rows for i in group])
                                if len(group) > 1 else group[0].rows)
                offs = np.cumsum([0] + [i.rows.shape[0] for i in group])
                for j, item in enumerate(group):
                    s, e = offs[j], offs[j + 1]
                    item.result = (tuple(a[s:e] for a in out)
                                   if isinstance(out, tuple) else out[s:e])
            except BaseException as exc:  # noqa: BLE001 — deliver to callers
                for item in group:
                    item.exc = exc
            finally:
                with self._cv:
                    self.batches += 1
                    self.rows += sum(i.rows.shape[0] for i in group)
                for item in group:
                    item.done.set()

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"requests": self.requests, "batches": self.batches,
                    "rows": self.rows}


class RetrievalService:
    """Request-level logic, HTTP-free (reused by tests and custom hosts).

    ``indexes`` maps name -> :class:`HashIndex`; the conventional names are
    ``"image"`` (searched by text queries) and ``"text"``.
    """

    def __init__(self, retriever, indexes: Optional[Dict[str, Any]] = None,
                 *, batching: bool = True, max_batch: int = 256,
                 window_ms: float = 0.0):
        self.retriever = retriever
        self.indexes: Dict[str, Any] = dict(indexes or {})
        self._device_lock = threading.Lock()
        self.batching = batching
        self._max_batch = max_batch
        self._window_ms = window_ms
        self._text_batcher = _Batcher(self._run_text, max_batch, window_ms)
        self._image_batcher = _Batcher(self._run_image, max_batch, window_ms)
        self._search_batchers: Dict[Tuple[str, int], _Batcher] = {}
        self._batchers_lock = threading.Lock()

    # ------------------------------------------------------ batched device ops
    def _bucketed(self, encode, rows: np.ndarray) -> np.ndarray:
        """One device call over a power-of-two row bucket (see _bucket);
        padded rows are sliced away before results leave the service."""
        n = rows.shape[0]
        b = _bucket(n, self._max_batch)
        with self._device_lock:
            out = encode(_pad0(rows, b), batch_size=min(b, self._max_batch))
        return out[:n]

    def _run_text(self, ids: np.ndarray) -> np.ndarray:
        return self._bucketed(self.retriever.encode_texts, ids)

    def _run_image(self, images: np.ndarray) -> np.ndarray:
        return self._bucketed(self.retriever.encode_images, images)

    def _search_batcher(self, name: str, k: int) -> _Batcher:
        with self._batchers_lock:
            batcher = self._search_batchers.get((name, k))
            if batcher is None:
                def run(q, _name=name, _k=k):
                    # bucket the coalesced query count like the encode path:
                    # without it every distinct group size would trace+compile
                    # a fresh search executable while holding the device lock
                    index = self._index(_name)
                    n = q.shape[0]
                    b = _bucket(n, self._max_batch)
                    with self._device_lock:
                        d, i = index.search(_pad0(q, b), _k)
                    return d[:n], i[:n]

                batcher = _Batcher(run, self._max_batch, self._window_ms)
                self._search_batchers[(name, k)] = batcher
            return batcher

    # ------------------------------------------------------------- requests
    def healthz(self) -> Dict[str, Any]:
        cfg = self.retriever.cfg
        with self._batchers_lock:
            search_stats = [b.stats() for b in self._search_batchers.values()]
        return {
            "ok": True,
            "method": cfg.method,
            "output_dim": cfg.output_dim,
            "max_words": cfg.max_words,
            "resolution": self.retriever.clip_cfg.image_resolution,
            "indexes": {name: len(ix) for name, ix in self.indexes.items()},
            "batching": {
                "enabled": self.batching,
                "window_ms": self._window_ms,
                "text": self._text_batcher.stats(),
                "image": self._image_batcher.stats(),
                "search": {key: sum(s[key] for s in search_stats)
                           for key in ("requests", "batches", "rows")},
            },
        }

    def _queries(self, body: Dict[str, Any]) -> np.ndarray:
        """Encode whichever modality the body carries -> ±1 codes.

        Validation and tokenization run on the calling thread; the device
        call goes through the modality's batcher, coalescing with any
        concurrent requests (see _Batcher)."""
        given = [k for k in ("texts", "ids", "images", "images_b64",
                             "images_jpeg_b64") if k in body]
        if len(given) != 1:
            raise ServiceError(
                "provide exactly one of 'texts', 'ids', 'images', "
                f"'images_b64', 'images_jpeg_b64' (got {given or 'none'})")
        if "texts" in body or "ids" in body:
            if "texts" in body:
                texts = body["texts"]
                if (not isinstance(texts, list)
                        or not all(isinstance(t, str) for t in texts)):
                    raise ServiceError("'texts' must be a list of strings")
                from ccmh_torch.tokenizer.bpe import tokenize_batch

                ids = np.asarray(
                    tokenize_batch(texts,
                                   max_words=self.retriever.cfg.max_words),
                    np.int32)
            else:  # pre-tokenized [B, max_words]
                try:
                    ids = np.asarray(body["ids"], np.int32)
                except (ValueError, TypeError):
                    raise ServiceError("'ids' must be a rectangular int array")
                mw = self.retriever.cfg.max_words
                if ids.ndim == 1 and ids.size == 0:
                    # "[]" decays to 1-D; it's an empty batch.  (ndim-2
                    # empties like [[], []] keep their shape and must fail
                    # the width check below — 2 rows in, 0 codes out with a
                    # 200 would silently drop rows.)
                    ids = ids.reshape(0, mw)
                if ids.ndim != 2 or ids.shape[1] != mw:
                    # width must be validated BEFORE enqueueing: a wrong-width
                    # row would fail the whole coalesced batch (np.concatenate
                    # in _Batcher), taking innocent tenants' requests with it
                    raise ServiceError(
                        f"'ids' must be [B, {mw}] (got {list(ids.shape)})")
            if not self.batching:
                with self._device_lock:
                    return self.retriever.encode_texts(
                        ids, batch_size=_batch_size(body))
            return self._text_batcher.submit(ids)
        res = self.retriever.clip_cfg.image_resolution
        if "images_jpeg_b64" in body:
            arr = _decode_jpeg_b64(body["images_jpeg_b64"], res)
        else:
            arr = (_decode_npy_b64(body["images_b64"])
                   if "images_b64" in body
                   else np.asarray(body["images"], np.float32))
        if arr.ndim != 4 or arr.shape[1:] != (res, res, 3):
            raise ServiceError(
                f"'images' must be [B, {res}, {res}, 3] CLIP-normalized "
                f"NHWC (got {list(arr.shape)})")
        if not self.batching:
            with self._device_lock:
                return self.retriever.encode_images(
                    arr, batch_size=_batch_size(body))
        return self._image_batcher.submit(arr)

    def encode(self, body: Dict[str, Any]) -> Dict[str, Any]:
        codes = self._queries(body)
        return {"codes": codes.astype(int).tolist()}

    def search(self, body: Dict[str, Any]) -> Dict[str, Any]:
        name = body.get("index", "image")
        index = self._index(name)
        k = int(body.get("k", 10))
        if not 1 <= k <= len(index):
            raise ServiceError(f"k must be in [1, {len(index)}] (got {k})")
        codes = self._queries(body)
        if self.batching:
            dist, idx = self._search_batcher(name, k).submit(codes)
        else:
            with self._device_lock:
                dist, idx = index.search(codes, k)
        return {"indices": idx.tolist(), "distances": dist.tolist()}

    def add(self, body: Dict[str, Any]) -> Dict[str, Any]:
        name = body.get("index", "image")
        if "codes" in body:
            try:
                codes = np.asarray(body["codes"], np.float32)
            except (ValueError, TypeError):
                raise ServiceError("'codes' must be a rectangular [M, K] array")
            if codes.ndim != 2:
                raise ServiceError(
                    f"'codes' must be [M, K] (got {list(codes.shape)})")
        else:
            codes = self._queries(body)
        with self._device_lock:
            index = self.indexes.get(name)
            try:
                if index is None:
                    # bootstrap: a daemon started without --gallery grows its
                    # first index from the first /v1/add
                    from ccmh_torch.retrieval import HashIndex

                    self.indexes[name] = HashIndex(
                        codes, **self.retriever._index_kw())
                else:
                    index.add(codes)
            except ValueError as exc:  # shape/width mismatch = client error
                raise ServiceError(str(exc))
        return {"index": name, "size": len(self.indexes[name])}

    def _index(self, name: str):
        try:
            return self.indexes[name]
        except KeyError:
            raise ServiceError(
                f"no index {name!r} (have {sorted(self.indexes)})") from None

    ROUTES = {"/v1/encode": encode, "/v1/search": search, "/v1/add": add}


def _decode_jpeg_b64(payload: Any, resolution: int) -> np.ndarray:
    """A list of base64 JPEG files -> CLIP-normalized NHWC float32, decoded
    by the native loader on the calling thread (GIL-free, so concurrent
    requests decode in parallel before they coalesce on the card)."""
    if not isinstance(payload, list) or not all(isinstance(p, str) for p in payload):
        raise ServiceError("'images_jpeg_b64' must be a list of base64 "
                           "strings (one raw image file each)")
    blobs = []
    for i, p in enumerate(payload):
        try:
            blobs.append(base64.b64decode(p, validate=True))
        except (binascii.Error, ValueError):
            raise ServiceError(f"images_jpeg_b64[{i}] is not valid base64") from None
    try:
        return images_from_bytes(blobs, resolution, is_train=False)
    except ValueError as exc:
        raise ServiceError(f"images_jpeg_b64: {exc}") from None


def _decode_npy_b64(payload: str) -> np.ndarray:
    try:
        arr = np.load(io.BytesIO(base64.b64decode(payload)),
                      allow_pickle=False)
    except Exception as exc:
        raise ServiceError(f"images_b64 is not a base64 .npy: {exc}") from None
    return np.asarray(arr, np.float32)


class _Handler(BaseHTTPRequestHandler):
    service: RetrievalService   # set by serve()

    # quiet by default; the daemon logs through its own logger
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._reply(200, self.service.healthz())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        handler = RetrievalService.ROUTES.get(self.path)
        if handler is None:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ServiceError("request body must be a JSON object")
            self._reply(200, handler(self.service, body))
        except ServiceError as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — keep the daemon alive
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})


def serve(service: RetrievalService, host: str = "127.0.0.1",
          port: int = 8080) -> ThreadingHTTPServer:
    """Bind and return the server (caller runs ``serve_forever``; tests run
    it on a daemon thread with ``port=0`` for an ephemeral port)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None) -> int:
    import argparse

    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import HashIndex, Retriever

    ap = argparse.ArgumentParser(
        description="cross-modal hash retrieval HTTP daemon")
    ap.add_argument("--method", required=True)
    ap.add_argument("--pretrained", required=True,
                    help="checkpoint: .npz in the ccmh Trainer format")
    ap.add_argument("--clip-path", default="",
                    help="converted CLIP .npz whose architecture the "
                         "checkpoint must match")
    ap.add_argument("--clip-arch", default=None,
                    choices=["vit-b-32", "tiny"],
                    help="architecture the checkpoint must match when "
                         "--clip-path is empty (default: whatever the "
                         "checkpoint's shapes say)")
    ap.add_argument("--output-dim", type=int, default=64)
    ap.add_argument("--nclass", type=int, default=80)
    ap.add_argument("--max-words", type=int, default=32)
    ap.add_argument("--gallery", default="",
                    help="image gallery: a HashIndex.save .npz, a PR_cruve "
                         ".mat (field r_img), or empty to start with no "
                         "index and fill via /v1/add")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:N or cpu)")
    ap.add_argument("--no-batching", action="store_true",
                    help="disable dynamic micro-batching (one device call "
                         "per request)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="coalesced-batch row cap / bucket chunk width")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="hold the first queued request open this long for "
                         "stragglers (0 = latency-neutral adaptive batching)")
    args = ap.parse_args(argv)

    cfg = Config(method=args.method, output_dim=args.output_dim,
                 nclass=args.nclass, max_words=args.max_words,
                 pretrained=args.pretrained, clip_path=args.clip_path)
    clip_cfg = None
    if not args.clip_path and args.clip_arch:
        from ccmh_torch.clip.model import ClipConfig

        clip_cfg = ClipConfig.tiny() if args.clip_arch == "tiny" else ClipConfig()
    retriever = Retriever.from_pretrained(cfg, clip_cfg=clip_cfg,
                                          device=args.device)
    indexes: Dict[str, Any] = {}
    if args.gallery.endswith(".mat"):
        indexes["image"] = HashIndex.from_mat(args.gallery,
                                              **retriever._index_kw())
    elif args.gallery:
        indexes["image"] = HashIndex.load(args.gallery,
                                          **retriever._index_kw())
    service = RetrievalService(retriever, indexes,
                               batching=not args.no_batching,
                               max_batch=args.max_batch,
                               window_ms=args.batch_window_ms)
    server = serve(service, args.host, args.port)
    print(f"serving {args.method} ({args.output_dim} bits) on "
          f"http://{args.host}:{server.server_address[1]}  "
          f"(indexes: { {k: len(v) for k, v in indexes.items()} })")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
