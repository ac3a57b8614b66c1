"""Top-k retrieval: HashIndex and Retriever (port of ``ccmh/retrieval.py``).

* :func:`topk_search` — exact top-k Hamming ranking with **deterministic
  tie-breaking**: equal distance -> lower gallery index wins, the stable
  order of the exact eval sort.  Each candidate is one int32 key
  ``(distance << idx_bits) | index``; gallery rows past ``valid_n`` take
  the maximum key, so they rank strictly last.  The keys are unique, so
  ``torch.topk`` on them gives the stable order.
* :class:`HashIndex` — a gallery of binary codes held on the device in the
  ±1 int8 form (one matmul per query chunk) or the packed form (32 bits per
  int32 lane, 8x smaller; the XOR+popcount kernel), plus optional labels
  for precision@k.  Saved and loaded in ``ccmh``'s ``.npz`` format (packed
  lanes stored as uint32).
* :class:`Retriever` — a trained method plus the BPE tokenizer: text ->
  image and image -> text search.  ``ccmh`` gets single-tower encoders
  from XLA dead-code elimination; PyTorch runs eagerly, so the port calls
  the method's per-tower encode functions and a text query never runs the
  vision tower.

Gallery-sharded and tensor-parallel search are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.convert import infer_clip_config, load_params_npz
from ccmh_torch.clip.model import cast_clip_params
from ccmh_torch.device import DeviceLike, resolve_device
from ccmh_torch.ops.hamming import hamming_distance, hamming_distance_packed
from ccmh_torch.ops.packing import pack_codes
from ccmh_torch.tokenizer.bpe import tokenize_batch
from ccmh_torch.train.checkpoint import load_checkpoint
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.methods.base import resolve_compute_dtype
from ccmh_torch.train.optim import tree_leaves_with_path

# combined sort key = (distance << idx_bits) | gallery_index, minimized;
# both parts must fit an int32
_KEY_BITS = 31
_SENTINEL = 2**_KEY_BITS - 1
# gallery capacity grows in blocks of this many rows (HashIndex.add)
_CAPACITY_BLOCK = 1024


def _idx_bits(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(2, n)))))


def _check_key_fits(n: int, max_dist: int) -> Tuple[int, int]:
    ib = _idx_bits(n)
    db = max(1, int(np.ceil(np.log2(max_dist + 2))))
    if ib + db > _KEY_BITS:
        raise ValueError(
            f"gallery of {n} items with max distance {max_dist} overflows the "
            f"int32 tie-break key ({ib}+{db} > {_KEY_BITS} bits); shard the "
            "gallery or reduce max_dist")
    return ib, db


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """Tensor, numpy array or nested list -> tensor on ``device`` (uint32
    packed lanes are viewed as the int32 patterns the port keeps)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _chunk_topk(dist: torch.Tensor, k: int, idx_bits: int,
                n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, N] int32 distances -> (distances [C, k], indices [C, k]).

    The key is built in place in ``dist`` (it is the caller's fresh
    distance matrix; at N=2^20 another [C, N] buffer would cost 4 GB)."""
    gidx = torch.arange(dist.shape[1], dtype=torch.int32, device=dist.device)
    key = dist.to(torch.int32)
    key <<= idx_bits
    key |= gidx
    key.masked_fill_(gidx >= n_valid, _SENTINEL)
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return top >> idx_bits, top & ((1 << idx_bits) - 1)


def topk_search(
    queries,
    gallery,
    k: int,
    *,
    dist_fn: Optional[Callable] = None,
    max_dist: Optional[int] = None,
    chunk: int = 1024,
    valid_n: Optional[int] = None,
    device: Optional[DeviceLike] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rank ``gallery`` for each query; return the k best.

    queries [Q, K] ±1 and gallery [N, K] ±1, or both packed (int32 tensors
    or uint32/int32 arrays; packing is detected from the gallery's dtype).
    ``gallery`` may be a tensor already on the device (HashIndex keeps it
    resident); otherwise it goes to ``device`` (default cuda).  ``dist_fn``
    overrides plain Hamming and must return int32 distances bounded by
    ``max_dist``.  ``valid_n``: true row count when the gallery carries
    spare rows (they rank strictly last and are never returned).
    Returns (distances [Q, k] int32, indices [Q, k] int32) as numpy.
    """
    if device is None:
        device = gallery.device if isinstance(gallery, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    g = _to_tensor(gallery, dev)
    packed = g.dtype == torch.int32
    n = valid_n if valid_n is not None else g.shape[0]
    k = min(k, n)
    n_queries = queries.shape[0]
    if n_queries == 0:
        return np.zeros((0, k), np.int32), np.zeros((0, k), np.int32)
    q_all = _to_tensor(queries, dev)
    if dist_fn is None:
        if packed:
            dist_fn, md = hamming_distance_packed, 32 * q_all.shape[1]
        else:
            dist_fn, md = hamming_distance, q_all.shape[1]
        max_dist = md if max_dist is None else max_dist
    elif max_dist is None:
        raise ValueError("custom dist_fn requires max_dist")
    # idx_bits covers the full CAPACITY (incl. spare rows), as in ccmh
    idx_bits, _ = _check_key_fits(g.shape[0], max_dist)
    out_d, out_i = [], []
    with torch.inference_mode():
        for s in range(0, n_queries, max(1, chunk)):
            d, i = _chunk_topk(dist_fn(q_all[s:s + chunk], g), k, idx_bits, n)
            out_d.append(d.cpu().numpy())
            out_i.append(i.cpu().numpy())
    return np.concatenate(out_d), np.concatenate(out_i)


class HashIndex:
    """A searchable gallery of binary codes on one device.

    codes: [N, K] ±1 (any float/int dtype).  ``packed=True`` stores the
    packed form (int32 lanes, 8x smaller than int8; XOR+popcount kernel);
    the default keeps ±1 int8 for the matmul path.  ``labels`` ([N, C]
    multi-hot) enables :meth:`precision_at_k`.  ``dist_fn`` (+
    ``max_dist``) replaces Hamming ranking.
    """

    def __init__(self, codes, labels=None, *, packed: bool = False,
                 dist_fn: Optional[Callable] = None,
                 max_dist: Optional[int] = None, chunk: int = 1024,
                 device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        codes = _to_tensor(codes, dev)
        if codes.ndim != 2 or codes.shape[1] == 0:
            # a zero-bit index would accept the build, then reject every
            # real-width add()/search() forever
            raise ValueError(f"codes must be [N, K>=1], got {list(codes.shape)}")
        if packed and dist_fn is not None:
            raise ValueError("packed storage implies Hamming ranking")
        self._setup(self._prepare(codes, packed), codes.shape[0], codes.shape[1],
                    labels, packed, dist_fn, max_dist, chunk, dev)

    @staticmethod
    def _prepare(codes: torch.Tensor, packed: bool) -> torch.Tensor:
        if packed:
            return pack_codes(codes)
        return torch.where(codes > 0, 1, -1).to(torch.int8)

    def _setup(self, prepared: torch.Tensor, n: int, k_bits: int, labels,
               packed: bool, dist_fn, max_dist, chunk: int, dev: torch.device) -> None:
        self.n, self.k_bits = n, k_bits
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and self.labels.shape[0] != self.n:
            raise ValueError("labels/codes row mismatch")
        self.packed = packed
        self.dist_fn = dist_fn
        self.max_dist = max_dist
        self.chunk = chunk
        self.device = dev
        # the gallery lives on the device for the index's lifetime; rows
        # past ``n`` are spare capacity for add()
        self._codes = prepared.to(dev).contiguous()

    def __len__(self) -> int:
        return self.n

    def add(self, codes, labels=None) -> None:
        """Append gallery items without rebuilding (streaming ingestion).

        Rows land in the device gallery's spare capacity in place; when it
        is full, capacity doubles (in 1024-row blocks).  Rows past ``n``
        rank strictly last through the search key sentinel, so a search
        after ``add`` equals a search over the concatenated gallery."""
        codes = _to_tensor(codes, self.device)
        if codes.ndim != 2 or codes.shape[1] != self.k_bits:
            raise ValueError(f"codes must be [M, {self.k_bits}], got {list(codes.shape)}")
        if (labels is None) != (self.labels is None):
            raise ValueError("add() labels must match how the index was built")
        if labels is not None and np.asarray(labels).shape[0] != codes.shape[0]:
            raise ValueError("labels/codes row mismatch")
        rows = self._prepare(codes, self.packed)
        m = rows.shape[0]
        capacity = self._codes.shape[0]
        if self.n + m > capacity:
            new_cap = max(2 * capacity,
                          -(-(self.n + m) // _CAPACITY_BLOCK) * _CAPACITY_BLOCK)
            grown = torch.zeros((new_cap,) + tuple(self._codes.shape[1:]),
                                dtype=self._codes.dtype, device=self.device)
            grown[:self.n] = self._codes[:self.n]
            self._codes = grown
        self._codes[self.n:self.n + m] = rows
        if labels is not None:
            self.labels = np.concatenate([self.labels, np.asarray(labels)])
        self.n += m

    @classmethod
    def from_mat(cls, path: str, field: str = "r_img",
                 label_field: str = "r_l", **kw) -> "HashIndex":
        """Build from a reference PR_cruve ``.mat`` dump
        (train/base.py:328-349 layout: q_img/q_txt/r_img/r_txt/q_l/r_l)."""
        import scipy.io as scio

        mat = scio.loadmat(path)
        labels = mat.get(label_field) if label_field else None
        return cls(mat[field], labels=labels, **kw)

    def save(self, path: str) -> None:
        """Persist the index in ``ccmh``'s npz format: prepared codes (int8
        ±1, or packed lanes as uint32), n, k_bits, packed, labels."""
        codes = self._codes[:self.n].cpu().numpy()
        if self.packed:
            codes = codes.view(np.uint32)
        arrays = {"codes": codes, "n": np.int64(self.n),
                  "k_bits": np.int64(self.k_bits), "packed": np.bool_(self.packed)}
        if self.labels is not None:
            arrays["labels"] = self.labels
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, **kw) -> "HashIndex":
        """Rebuild a saved index (either package's files).  Codes were stored
        prepared, so loading is one transfer to the device; ``kw`` takes
        the build options again (dist_fn=+max_dist=, chunk=, device=)."""
        with np.load(path) as data:
            packed = bool(data["packed"])
            codes = np.asarray(data["codes"])
            labels = np.asarray(data["labels"]) if "labels" in data else None
            n, k_bits = int(data["n"]), int(data["k_bits"])
        if not packed:
            return cls(codes, labels=labels, **kw)  # int8 ±1 re-prepares to itself
        if kw.get("dist_fn") is not None:
            raise ValueError("packed storage implies Hamming ranking")
        dev = resolve_device(kw.get("device", "cuda"))
        self = cls.__new__(cls)
        self._setup(_to_tensor(codes, dev), n, k_bits, labels, True, None,
                    kw.get("max_dist"), kw.get("chunk", 1024), dev)
        return self

    def _prep_queries(self, queries) -> torch.Tensor:
        q = _to_tensor(queries, self.device)
        if self.dist_fn is not None:
            return q
        return self._prepare(q, self.packed)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries [Q, K] ±1 -> (distances [Q, k], gallery indices [Q, k])."""
        return topk_search(self._prep_queries(queries), self._codes, k,
                           dist_fn=self.dist_fn, max_dist=self.max_dist,
                           chunk=self.chunk, valid_n=self.n)

    def precision_at_k(self, queries, query_labels, k: int) -> float:
        """Mean fraction of top-k hits sharing >= 1 label with the query
        (the label-overlap relevance of calc_neighbor, utils/utils.py:26)."""
        if self.labels is None:
            raise ValueError("index built without labels")
        _, idx = self.search(queries, k)
        ql = np.asarray(query_labels)
        hit = np.einsum("qc,qkc->qk", ql.astype(np.float64),
                        self.labels[idx].astype(np.float64)) > 0
        return float(hit.mean())


class Retriever:
    """Trained method + tokenizer -> cross-modal search on one device.

    ``params`` is the method's parameter tree of tensors (``clip`` plus the
    head trees, ``ccmh``'s layout; ``bridge.params_from_jax`` converts
    ``ccmh``'s).  Under ``cfg.compute_dtype="bfloat16"`` the tower weights
    are cast to bf16 once here.  Encoding runs under
    ``torch.inference_mode()``.
    """

    def __init__(self, method, params, aux, cfg, clip_cfg,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.method = method
        self.cfg = cfg
        self.clip_cfg = clip_cfg
        params = _to_device(params, self.device)
        dtype = resolve_compute_dtype(cfg)
        if dtype != torch.float32:
            params = {**params, "clip": cast_clip_params(params["clip"], dtype)}
        self.params = params
        self.aux = _to_device(aux, self.device)
        self._dist_fn = (method.dist_fn(cfg)
                         if method.dist_fn is not None else None)

    @classmethod
    def from_pretrained(cls, cfg, clip_cfg=None,
                        device: DeviceLike = "cuda") -> "Retriever":
        """Dataset-free serving construction from ``cfg.pretrained``, an
        ``.npz`` checkpoint in ``ccmh``'s Trainer format.

        The architecture is inferred from the checkpoint's shapes (``ccmh``
        takes it from ``cfg.clip_path`` or ``clip_cfg`` and defaults to
        ViT-B/32); when ``cfg.clip_path`` or ``clip_cfg`` names one, it
        must agree."""
        if not cfg.pretrained:
            raise ValueError("from_pretrained requires cfg.pretrained")
        dev = resolve_device(device)
        method = get_method(cfg.method)
        ckpt = load_checkpoint(cfg.pretrained)
        tree = ckpt["params"]
        if "clip" not in tree:
            raise ValueError(f"{cfg.pretrained} holds no params/clip/... tower")
        found = infer_clip_config(tree["clip"])
        if cfg.clip_path:
            clip_cfg = load_params_npz(cfg.clip_path, device="cpu")[1]
        if clip_cfg is not None and clip_cfg != found:
            raise ValueError(
                f"checkpoint {cfg.pretrained} holds a {found} tower but "
                f"{clip_cfg} was asked for")
        # the head trees' shapes; a tree whose shapes follow the class count
        # (a label net, loss heads), which serving does not know, is found by
        # initialising the method at two class counts and is not checked
        def shapes(t):
            return {k: tuple(np.shape(v)) for k, v in tree_leaves_with_path(t)}
        heads, _, _ = method.init(torch.Generator(), cfg.replace(nclass=1), found)
        other, _, _ = method.init(torch.Generator(), cfg.replace(nclass=2), found)
        for name in heads:
            want = shapes(heads[name])
            if want != shapes(other[name]):
                continue
            got = shapes(tree.get(name, {}))
            if want != got:
                raise ValueError(f"checkpoint head {name!r} has shapes {got}, "
                                 f"{cfg.method} K={cfg.output_dim} needs {want}")
        return cls(method, params_from_jax(tree, device=dev),
                   params_from_jax(ckpt["aux"], device=dev), cfg, found,
                   device=dev)

    # ------------------------------------------------------------- encoding
    def _chunked(self, fn, arr: np.ndarray, batch_size: int) -> np.ndarray:
        if arr.shape[0] == 0:
            # one zero row probes the output width/dtype, then slice to empty
            probe = np.zeros((1,) + arr.shape[1:], arr.dtype)
            return self._chunked(fn, probe, 1)[:0]
        out = []
        bs = max(1, batch_size)
        with torch.inference_mode():
            for s in range(0, arr.shape[0], bs):
                part = torch.from_numpy(np.ascontiguousarray(arr[s:s + bs])).to(self.device)
                codes = fn(self.params, self.aux, part, self.cfg, self.clip_cfg)
                out.append(codes.cpu().numpy())
        return np.concatenate(out)

    def encode_texts(self, texts, batch_size: int = 256) -> np.ndarray:
        """list[str] (host BPE tokenize, dataset/base.py:64-81 semantics)
        or pre-tokenized [B, max_words] int ids -> ±1 int8 codes."""
        if isinstance(texts, (list, tuple)) and texts and isinstance(texts[0], str):
            ids = tokenize_batch(texts, max_words=self.cfg.max_words)
        else:
            ids = np.asarray(texts, np.int32)
            if ids.ndim == 1 and ids.size == 0:
                # [] decays to 1-D; the empty-batch probe needs [0, max_words]
                ids = ids.reshape(0, self.cfg.max_words)
        return self._chunked(self.method.encode_text, ids.astype(np.int32), batch_size)

    def encode_images(self, images, batch_size: int = 256) -> np.ndarray:
        """[B, H, W, 3] CLIP-normalized float images -> ±1 int8 codes."""
        images = np.asarray(images, np.float32)
        if images.ndim == 1 and images.size == 0:
            r = self.clip_cfg.image_resolution
            images = images.reshape(0, r, r, 3)
        return self._chunked(self.method.encode_image, images, batch_size)

    # ------------------------------------------------------------- indexing
    def _index_kw(self) -> Dict[str, Any]:
        kw: Dict[str, Any] = {"device": self.device}
        if self._dist_fn is not None:
            kw["dist_fn"] = self._dist_fn
            kw["max_dist"] = self.cfg.output_dim
        return kw

    def build_image_index(self, images=None, codes=None, labels=None,
                          **kw) -> HashIndex:
        if codes is None:
            codes = self.encode_images(images)
        return HashIndex(codes, labels=labels, **{**self._index_kw(), **kw})

    def build_text_index(self, texts=None, codes=None, labels=None,
                         **kw) -> HashIndex:
        if codes is None:
            codes = self.encode_texts(texts)
        return HashIndex(codes, labels=labels, **{**self._index_kw(), **kw})

    # ------------------------------------------------------------- search
    def search_text2image(self, texts, index: HashIndex,
                          k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        return index.search(self.encode_texts(texts), k)

    def search_image2text(self, images, index: HashIndex,
                          k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        return index.search(self.encode_images(images), k)


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)
