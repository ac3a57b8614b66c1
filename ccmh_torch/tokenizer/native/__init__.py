"""ctypes binding of the native C++ BPE tokenizer (the port's copy of
``ccmh``'s ``bpe.cpp``, same C entry ``ccmh_bpe_encode_batch``).

The library is built with ``g++`` at first use into the git-ignored
``build/ccmh_torch_host/`` (``utils/host_build.py``); a failed build
raises.  It covers the texts on which the reference cleaning (ftfy and a
double HTML unescape) is the identity up to lowercase and whitespace:
ASCII, no ``&`` (HTML entities), no ``<|`` (literal special tokens), see
:func:`eligible`.  On those its ids equal the Python tokenizer's exactly;
``tokenize_batch`` sends the rest through the Python path.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ccmh_torch.tokenizer.bpe import DEFAULT_VOCAB_PATH, VOCAB_SIZE
from ccmh_torch.utils import host_build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe.cpp")
FLAGS = ("-O2", "-std=c++17", "-pthread")    # ccmh's flags
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_HANDLES: Dict[str, ctypes.c_void_p] = {}    # vocab path -> tokenizer


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(host_build.build(SRC, "bpe", FLAGS))
            lib.ccmh_bpe_create.restype = ctypes.c_void_p
            lib.ccmh_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
            lib.ccmh_bpe_destroy.restype = None
            lib.ccmh_bpe_destroy.argtypes = [ctypes.c_void_p]
            lib.ccmh_bpe_encode_batch.restype = ctypes.c_int
            lib.ccmh_bpe_encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            _LIB = lib
        return _LIB


def _handle(vocab_path: str) -> ctypes.c_void_p:
    lib = _lib()
    with _LOCK:
        handle = _HANDLES.get(vocab_path)
        if handle is None:
            with gzip.open(vocab_path, "rb") as fh:
                lines = fh.read().split(b"\n")
            n_merges = VOCAB_SIZE - 2 * 256 - 2
            merges = b"\n".join(lines[1:1 + n_merges])
            raw = lib.ccmh_bpe_create(merges, len(merges), n_merges)
            if not raw:
                raise RuntimeError(f"native tokenizer refused the vocab {vocab_path}")
            handle = _HANDLES[vocab_path] = ctypes.c_void_p(raw)
        return handle


def eligible(text: str) -> bool:
    """True where the native path is exact for ``text``: ASCII only (no
    Unicode lowercasing, ftfy or letter classes apply), no HTML entities
    (the reference unescapes twice), no literal special tokens."""
    return text.isascii() and "&" not in text and "<|" not in text


def encode_padded_batch(texts: Sequence[str], max_words: int,
                        vocab_path: str = DEFAULT_VOCAB_PATH,
                        n_threads: int = 0) -> np.ndarray:
    """Eligible texts -> int32 [B, max_words]: SOT + tokens (truncated) +
    EOT, zero-padded.  The call releases the GIL and fans the words out
    over C++ threads."""
    handle = _handle(vocab_path)
    n = len(texts)
    out = np.zeros((n, max_words), np.int32)
    if n == 0:
        return out
    bad = [i for i, t in enumerate(texts) if not eligible(t)]
    if bad:
        raise ValueError(f"text {bad[0]} is not eligible for the native tokenizer: "
                         f"{texts[bad[0]]!r}")
    c_texts = (ctypes.c_char_p * n)(*[t.encode("ascii") for t in texts])
    if n_threads <= 0:
        n_threads = min(8, max(1, n // 64)) if n > 64 else 1
    _lib().ccmh_bpe_encode_batch(handle, c_texts, n, max_words,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 max(1, n_threads))
    return out
